"""Built-in UI served at /zipkin/: a hash-routed single-page app (the
port's copy of ``zipkin_tpu/server/ui.py:1-52``, with ``static/`` copied
byte for byte from ``zipkin_tpu/server/static/``).

The reference serves the Lens React bundle from its server jar; this app
keeps API-shape compatibility with Lens (held by
``tests/test_torch_lens_conformance.py``) and ships a dependency-free app
for the same views: Discover, the trace waterfall, dependencies and the
sketch views. The UI is a client of the JSON API only.

The assets are plain files under ``static/`` beside this module (no build
step). Only names on a fixed allowlist resolve, so a request path never
reaches the filesystem.
"""

import mimetypes
import os
from typing import Optional

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")

_ASSETS = ("index.html", "app.js", "style.css")
_cache: dict = {}


def asset(name: str) -> Optional[tuple]:
    """(bytes, content_type) for a bundled asset, or None.

    Only names in the fixed allowlist resolve — the request path never
    touches the filesystem, so traversal is structurally impossible.
    """
    if name not in _ASSETS:
        return None
    if name not in _cache:
        with open(os.path.join(STATIC_DIR, name), "rb") as f:
            body = f.read()
        ctype = mimetypes.guess_type(name)[0] or "application/octet-stream"
        _cache[name] = (body, ctype)
    return _cache[name]


def index_page() -> str:
    body, _ = asset("index.html")
    return body.decode("utf-8")
