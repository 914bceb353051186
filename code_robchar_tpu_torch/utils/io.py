"""JSON IO (the ``load_json`` and ``dump_json`` of
code_robchar_tpu/utils/io.py: framework-free host code, which the port
cannot import from the JAX package, since importing any of it pulls in
jax)."""

from __future__ import annotations

import json
import os
from typing import Any


def load_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def dump_json(obj: Any, path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)  # atomic: a crashed writer never corrupts a cache
