"""The tracer's gate: no Lens read is in flight while it is held, and
reads go on once it is released."""

import sys
import threading
import time

from portbench.drive import Gate


def test_no_read_in_flight_under_the_gate():
    gate, lock = Gate(), threading.Lock()
    active = [0]
    seen = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def reader():
            for _ in range(200):
                with gate.reading():
                    with lock:
                        active[0] += 1
                    time.sleep(0.0001)
                    with lock:
                        active[0] -= 1

        threads = [threading.Thread(target=reader) for _ in range(12)]
        for t in threads:
            t.start()
        for _ in range(30):
            with gate.exclusive():
                with lock:
                    seen.append(active[0])
                time.sleep(0.0005)
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert seen == [0] * 30 and active[0] == 0
