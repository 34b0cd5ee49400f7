"""Package rules of the PyTorch port: it never imports JAX or the JAX
package, and its entry points default to the card and refuse to run
without one unless the caller asks for the CPU."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest
import torch
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "zipkin_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "zipkin_tpu")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_the_archive_and_scrubber_modules_are_checked():
    """The disk archive and the scrubber are copies of modules the JAX
    package holds: both are under the import checks above."""
    mods = _modules()
    for m in ("zipkin_tpu_torch.tpu.archive", "zipkin_tpu_torch.runtime.scrub"):
        assert m in mods
        bad = [r for r in _imported_roots(ROOT / (m.replace(".", "/") + ".py")) if r in FORBIDDEN]
        assert not bad, f"{m} imports {bad}"


ADMISSION = ("zipkin_tpu_torch.runtime.overload", "zipkin_tpu_torch.runtime.tenant",
             "zipkin_tpu_torch.runtime.supervisor")


def test_the_admission_modules_are_checked_and_load_no_torch():
    """The overload controller, the tenant table and the resume supervisor
    are under the import checks above, and load neither torch nor numpy:
    the collector and the spawn paths import them."""
    mods = _modules()
    for m in ADMISSION:
        assert m in mods
        bad = [r for r in _imported_roots(ROOT / (m.replace(".", "/") + ".py")) if r in FORBIDDEN]
        assert not bad, f"{m} imports {bad}"
    code = (
        "import importlib, sys\n"
        f"for m in {ADMISSION!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('torch', 'numpy', 'jax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_aggregator_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
    from zipkin_tpu_torch.tpu.state import AggConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = AggConfig(max_services=4, max_keys=8, hll_precision=4, digest_centroids=4,
                      digest_buffer=64, ring_capacity=64, time_buckets=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchAggregator(small)
    with pytest.raises(RuntimeError):
        TorchAggregator(small, device="cuda")
    assert TorchAggregator(small, device="cpu").states[0].hll.device.type == "cpu"


def test_storage_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The store's aggregator resolves to the card; without one it raises
    unless the caller names the CPU, and clear() keeps the device."""
    from zipkin_tpu_torch.tpu.store import TorchStorage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = _small_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchStorage(config=small, pad_to_multiple=32)
    with pytest.raises(RuntimeError):
        TorchStorage(config=small, pad_to_multiple=32, device="cuda")
    store = TorchStorage(config=small, pad_to_multiple=32, device="cpu")
    store.clear()
    assert store.agg.device.type == "cpu" and store.agg.states[0].hll.device.type == "cpu"


def _small_config():
    from zipkin_tpu_torch.tpu.state import AggConfig

    return AggConfig(max_services=4, max_keys=8, hll_precision=4, digest_centroids=4,
                     digest_buffer=64, ring_capacity=64, time_buckets=0)


@pytest.mark.parametrize("entry", ["state_from_numpy", "init_state", "new_registers",
                                   "new_histograms", "init_ctx"])
def test_state_builders_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    """Every function that builds state puts it on the card unless the
    caller names a device; with no card and no device it raises."""
    from zipkin_tpu_torch import convert
    from zipkin_tpu_torch.ops import delta_linker, histogram, hll
    from zipkin_tpu_torch.tpu.state import init_state

    cfg = _small_config()
    build = {
        "state_from_numpy": lambda **kw: convert.state_from_numpy(
            convert.state_to_numpy([init_state(cfg, device="cpu")]), cfg, **kw)[0].hll,
        "init_state": lambda **kw: init_state(cfg, **kw).hll,
        "new_registers": lambda **kw: hll.new_registers(4, 4, **kw),
        "new_histograms": lambda **kw: histogram.new_histograms(8, **kw),
        "init_ctx": lambda **kw: delta_linker.init_ctx(16, **kw).order,
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    with pytest.raises(RuntimeError):
        build(device="cuda")
    assert build(device="cpu").device.type == "cpu"


def test_hll_kernel_refuses_bad_inputs_before_building():
    """The CUDA wrapper checks device, dtype and shape in Python; on the
    CPU it takes the plain path only because the tensor is on the CPU."""
    from zipkin_tpu_torch.ops import hll_kernel

    regs = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="unsupported device"):
        hll_kernel.update(regs, one, one, torch.zeros(1, dtype=torch.bool))


def test_server_entry_defaults_to_the_card_and_refuses_without_one(tmp_path):
    """``python -m zipkin_tpu_torch.server`` with no storage flag builds the
    card's store; with no card it fails to start instead of serving from
    memory. ``--storage mem`` is the caller's own request."""
    import os

    env = {k: v for k, v in os.environ.items() if k != "STORAGE_TYPE"}
    env.update(CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "zipkin_tpu_torch.server", "--port", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    from zipkin_tpu_torch.server.config import ServerConfig

    assert ServerConfig().storage_type == "tpu"


DURABLE = ("zipkin_tpu_torch.tpu.wal", "zipkin_tpu_torch.tpu.snapshot", "zipkin_tpu_torch.storage.tpu",
           "zipkin_tpu_torch.faults")


def test_durable_boot_modules_load_no_jax_and_no_aiohttp():
    code = (
        "import importlib, sys\n"
        f"for m in {DURABLE!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN + ('aiohttp', 'grpc')!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_resume_adapter_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    """The resume adapter builds, restores and replays on the card; with no
    card it raises before touching its dirs unless the caller names the
    CPU, as the core store does."""
    from zipkin_tpu_torch.storage.tpu import TorchStorage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dirs = dict(checkpoint_dir=str(tmp_path / "snap"), wal_dir=str(tmp_path / "wal"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchStorage(config=_small_config(), batch_size=32, **dirs)
    with pytest.raises(RuntimeError):
        TorchStorage(config=_small_config(), batch_size=32, device="cuda", **dirs)
    assert not (tmp_path / "wal").exists()
    store = TorchStorage(config=_small_config(), batch_size=32, device="cpu", **dirs)
    assert store.agg.states[0].hll.device.type == "cpu" and store.snapshot()
    store.close()
    again = TorchStorage(config=_small_config(), batch_size=32, device="cpu", **dirs)
    assert again.agg.states[0].hll.device.type == "cpu"
    again.close()


def test_the_fan_out_modules_are_checked():
    """The span ring, the multi-process tier and the feeder are ports of
    modules the JAX package holds: all are under the import checks above."""
    mods = _modules()
    for m in ("zipkin_tpu_torch.tpu.ring", "zipkin_tpu_torch.tpu.mp_ingest",
              "zipkin_tpu_torch.tpu.feeder"):
        assert m in mods
        bad = [r for r in _imported_roots(ROOT / (m.replace(".", "/") + ".py")) if r in FORBIDDEN]
        assert not bad, f"{m} imports {bad}"


def test_fault_catalogs_equal_the_reference():
    """The crash, corrupt and resource site catalogs are the reference's
    (the resource sites now include ``feed.latency`` and ``alloc``)."""
    from zipkin_tpu import faults as ref_faults
    from zipkin_tpu_torch import faults

    assert faults.SITES == ref_faults.SITES
    assert faults.CORRUPT_SITES == ref_faults.CORRUPT_SITES
    assert faults.RESOURCE_SITES == ref_faults.RESOURCE_SITES
    assert faults.RESOURCE_SITES == ("wal.append", "snapshot", "archive", "feed.latency", "alloc")


@pytest.mark.parametrize("site", ["feed.latency", "alloc", "wal.append"])
def test_resource_sites_behave_as_the_reference(site):
    """Armed for two traversals: ``feed.latency`` sleeps its latency and
    returns, ``alloc`` raises MemoryError, a disk site raises ENOSPC, in
    both packages alike; the third traversal passes."""
    import time as _time

    from zipkin_tpu import faults as ref_faults
    from zipkin_tpu_torch import faults

    outcomes = []
    for mod in (faults, ref_faults):
        mod.arm_resource(site, nth=1, count=2, latency_ms=50.0)
        try:
            got = []
            for _ in range(3):
                t0 = _time.perf_counter()
                try:
                    mod.resource_point(site)
                    got.append(("ok", _time.perf_counter() - t0 >= 0.045))
                except MemoryError:
                    got.append(("MemoryError", None))
                except OSError as e:
                    got.append((f"OSError {e.errno}", None))
            outcomes.append(got)
            assert not mod.is_resource_armed(site)
        finally:
            mod.disarm()
    assert outcomes[0] == outcomes[1]
    want_first = {"feed.latency": ("ok", True), "alloc": ("MemoryError", None)}.get(
        site, ("OSError 28", None))
    assert outcomes[0][:2] == [want_first] * 2 and outcomes[0][2] == ("ok", False)
