"""Asset path resolution (the reference's FindAsset).

Copy of the JAX package's ``io/assets.py``, cut to the paths inside the
checkout: the working directory, ``<type>/`` and ``assets/<type>/`` under
it, and the checkout's own ``assets/<type>/``.  The JAX package also
searches the parent directory and a reference checkout outside the
repository; the port reads nothing outside its checkout, so a missing asset
raises ``FileNotFoundError`` here as it does there.
"""

from __future__ import annotations

import os

_REPO_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets")


def find_asset(filename: str, asset_type: str) -> str:
    base = os.path.basename(filename)
    candidates = [
        filename,
        os.path.join(asset_type, filename),
        os.path.join("assets", asset_type, filename),
        os.path.join(_REPO_ASSETS, asset_type, base),
    ]
    # Scene paths read like "assets/hdri/foo.hdr": also try the basename
    # under the assets root.
    if base != filename:
        candidates.append(os.path.join("assets", asset_type, base))
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"asset '{filename}' (type {asset_type}) not found; searched {candidates}"
    )
