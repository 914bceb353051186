"""ctypes binding for the native Monte-Carlo cache codec
(code_robchar_tpu_torch/csrc/mccodec.cpp; a copy of
code_robchar_tpu/utils/native_io.py, framework-free host code that the
port cannot import from the JAX package).

The .mc interchange files hold tens of millions of floats as JSON nested
lists (mcsim.py:457-459 schema); CPython's json is the bottleneck of the
cache layer at paper scale.  This module builds the port's own
``build/libmccodec.so`` with g++ on first use (never the JAX package's
``native/build/libmccodec.so``; the source is a copy of
``native/mccodec.cpp``, so both write the same bytes) and exposes

    encode_tensor(np.ndarray)  -> str     (JSON nested lists, shortest round-trip)
    decode_tensor(str)         -> np.ndarray
    dump_mc(dict[str, array], path) / load_mc(path)

with graceful fallback to the pure-json path when no compiler is available
(the on-disk format is identical either way); ``native_available()`` says
which codec runs.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PACKAGE_DIR, "csrc", "mccodec.cpp")
_LIB_DIR = os.path.join(_PACKAGE_DIR, "build")
_LIB = os.path.join(_LIB_DIR, "libmccodec.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or (
                    os.path.exists(_SRC) and
                    os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
                os.makedirs(_LIB_DIR, exist_ok=True)
                # atomic: a concurrent loader sees the old library or the
                # whole new one
                tmp = f"{_LIB}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True)
                os.replace(tmp, _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.rc_decode_array.restype = ctypes.c_int
            lib.rc_decode_array.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.c_longlong)]
            lib.rc_encode_array.restype = ctypes.c_int
            lib.rc_encode_array.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_longlong)]
            lib.rc_free.restype = None
            lib.rc_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            _build_failed = True
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeCodecError(RuntimeError):
    """The C codec rejected the input (negative rc from mccodec.cpp)."""


def _encode_native_bytes(arr: np.ndarray, lib: ctypes.CDLL) -> bytes:
    shape = (ctypes.c_longlong * 8)(*arr.shape, *([0] * (8 - arr.ndim)))
    out = ctypes.c_char_p()
    ln = ctypes.c_longlong()
    rc = lib.rc_encode_array(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), shape,
        arr.ndim, ctypes.byref(out), ctypes.byref(ln))
    if rc != 0:
        raise NativeCodecError(f"rc_encode_array rc={rc}")
    try:
        return ctypes.string_at(out, ln.value)
    finally:
        lib.rc_free(out)


def _encode_native(arr: np.ndarray, lib: ctypes.CDLL) -> str:
    return _encode_native_bytes(arr, lib).decode()


def _decode_native(text: str, lib: ctypes.CDLL) -> np.ndarray:
    shape = (ctypes.c_longlong * 8)()
    ndim = ctypes.c_int()
    data = ctypes.POINTER(ctypes.c_double)()
    count = ctypes.c_longlong()
    rc = lib.rc_decode_array(text.encode(), shape, ctypes.byref(ndim),
                             ctypes.byref(data), ctypes.byref(count))
    if rc != 0:
        raise NativeCodecError(f"rc_decode_array rc={rc}")
    try:
        arr = np.ctypeslib.as_array(data,
                                    shape=(count.value,)).copy()
    finally:
        lib.rc_free(ctypes.cast(data, ctypes.c_void_p))
    return arr.reshape(tuple(shape[i] for i in range(ndim.value)))


def encode_tensor(arr: np.ndarray) -> str:
    """numpy array -> JSON nested-list text (native fast path)."""
    lib = _load()
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    if lib is None or arr.ndim < 1 or arr.ndim > 8 or arr.size == 0:
        return json.dumps(arr.tolist())
    try:
        return _encode_native(arr, lib)
    except NativeCodecError:
        return json.dumps(arr.tolist())


def decode_tensor(text: str) -> np.ndarray:
    """JSON nested-list text -> numpy array (native fast path).

    Falls back to stdlib json only when the codec rejects the input
    (non-rectangular / non-numeric), mirroring what np.asarray of the
    json value would reject too."""
    lib = _load()
    if lib is None:
        return np.asarray(json.loads(text), dtype=float)
    try:
        return _decode_native(text, lib)
    except NativeCodecError:
        return np.asarray(json.loads(text), dtype=float)


#: binary sidecar for .mc caches: alongside the canonical JSON, write a
#: `<path>.mcb` (numpy .npz container) and prefer it on reload when fresh.
#: The JSON stays byte-compatible with the reference and is never skipped
#: on write — the sidecar only removes the reload-time parse (the .mc body
#: for the paper workload is ~200 MB of text).  Disable with
#: ROBCHAR_MC_SIDECAR=0.
SIDECAR = os.environ.get("ROBCHAR_MC_SIDECAR", "1") != "0"


def _sidecar_path(path: str) -> str:
    return path + ".mcb"


def dump_mc(tensors: Dict[str, np.ndarray], path: str) -> None:
    """Write the .mc envelope {algo: nested lists} with native-encoded
    tensor bodies.  The output is valid JSON with the reference schema
    (mcsim.py:457-459) and every float round-trips bit-exactly, but the
    number RENDERING is std::to_chars shortest round-trip (e.g. 5.0
    renders as '5' where Python repr gives '5.0') —
    parse-compatible, not byte-identical, with a json.dump of the same
    dict.  Also writes the binary sidecar (see SIDECAR)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    lib = _load()
    tmp = path + ".tmp"
    # binary mode: tensor bodies come back from the codec as ASCII bytes;
    # writing them directly skips a ~200 MB bytes->str decode per paper
    # tensor (the file contents are identical)
    with open(tmp, "wb") as f:
        f.write(b"{")
        for i, (name, arr) in enumerate(tensors.items()):
            if i:
                f.write(b", ")
            f.write(json.dumps(name).encode())
            f.write(b": ")
            a = np.ascontiguousarray(np.asarray(arr), dtype=np.float64)
            if lib is None or a.ndim < 1 or a.ndim > 8 or a.size == 0:
                f.write(json.dumps(a.tolist()).encode())
            else:
                try:
                    f.write(_encode_native_bytes(a, lib))
                except NativeCodecError:
                    f.write(json.dumps(a.tolist()).encode())
        f.write(b"}")
    os.replace(tmp, path)
    if SIDECAR:
        sc_tmp = _sidecar_path(path) + ".tmp.npz"
        np.savez(sc_tmp[:-4],
                 **{k: np.asarray(v, dtype=float)
                    for k, v in tensors.items()})
        os.replace(sc_tmp, _sidecar_path(path))


def load_mc(path: str) -> Dict[str, np.ndarray]:
    """Read a .mc envelope into {algo: ndarray}.

    Top-level scan is a tiny string/bracket walker (the envelope has one
    level of string keys over pure array values); array bodies go through
    the native decoder.
    """
    if SIDECAR:
        sc = _sidecar_path(path)
        if os.path.exists(sc) and \
                os.path.getmtime(sc) >= os.path.getmtime(path):
            with np.load(sc) as z:
                return {k: z[k] for k in z.files}
    with open(path, "r") as f:
        text = f.read()
    lib = _load()
    if lib is None:
        return {k: np.asarray(v, dtype=float)
                for k, v in json.loads(text).items()}

    out: Dict[str, np.ndarray] = {}
    i = text.find("{") + 1
    n = len(text)
    while i < n:
        # next key
        ks = text.find('"', i)
        if ks < 0:
            break
        ke = ks + 1
        while ke < n:  # honour escapes
            ke = text.find('"', ke)
            if ke < 0:
                return {k: np.asarray(v, dtype=float)
                        for k, v in json.loads(text).items()}
            if text[ke - 1] != "\\":
                break
            ke += 1
        key = json.loads(text[ks:ke + 1])
        a0 = text.find("[", ke)
        depth = 0
        j = a0
        while j < n:
            c = text[j]
            if c == "[":
                depth += 1
            elif c == "]":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        out[key] = decode_tensor(text[a0:j + 1])
        i = j + 1
    return out
