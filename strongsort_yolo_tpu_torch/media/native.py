"""ctypes binding of the native C++ drawing shim (``native/media_shim.cpp``).

Counterpart of ``strongsort_yolo_tpu/media/native.py``. On first use
``libmedia_shim.so`` is compiled with ``g++`` (or ``$CXX``) from the
tracked source, with the flags of ``native/Makefile`` but
``-march=native`` (a copied build directory then runs on any x86-64
host; the pixels are the same), into
``build/media/`` at the repository root, named by a hash of the sources
and flags (an edit rebuilds, an unchanged tree reuses the file);
nothing is built inside ``native/``. Where no compiler or no build
works, ``available()`` is False and ``build_error`` holds the
compiler's message. The binding has the drawing surface the annotator
uses, so the cv2 and native backends are interchangeable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time

import numpy as np

from strongsort_yolo_tpu_torch.media.native_decoder import NATIVE_DIR

SOURCES = (os.path.join(NATIVE_DIR, "media_shim.cpp"),
           os.path.join(NATIVE_DIR, "font_gen.h"))
BUILD_DIR = os.path.join(os.path.dirname(NATIVE_DIR), "build", "media")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False
build_seconds: float | None = None  # this process's compile, if it ran one
build_error: str | None = None  # why the library is unavailable


def lib_path() -> str:
    h = hashlib.sha256()
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmedia_shim_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    global build_seconds
    cxx = os.environ.get("CXX") or "g++"
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    # a private directory, then a rename: a concurrent process never
    # loads a half-written file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = os.path.join(tmp, "lib.so")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp_out, SOURCES[0]],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}): "
                               f"{proc.stderr.strip()}")
        os.replace(tmp_out, out)
    build_seconds = time.perf_counter() - t0


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        try:
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.shim_draw_rect.argtypes = [u8p] + [ctypes.c_int] * 6 + [
            ctypes.c_uint8] * 3 + [ctypes.c_int]
        lib.shim_draw_line.argtypes = lib.shim_draw_rect.argtypes
        lib.shim_draw_polyline.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
            i32p, ctypes.c_int, ctypes.c_int] + [ctypes.c_uint8] * 3 + [
            ctypes.c_int]
        lib.shim_fill_poly.argtypes = [u8p, ctypes.c_int, ctypes.c_int, i32p,
            ctypes.c_int] + [ctypes.c_uint8] * 3
        lib.shim_blend.argtypes = [u8p, u8p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_float]
        lib.shim_draw_text.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int] + [
            ctypes.c_uint8] * 3
        lib.shim_text_size.argtypes = [ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def draw_rect(img, x1, y1, x2, y2, color, thickness=1):
    b, g, r = (int(c) for c in color)
    _load().shim_draw_rect(_ptr(img), img.shape[0], img.shape[1],
                           int(x1), int(y1), int(x2), int(y2), b, g, r,
                           int(thickness))


def draw_line(img, x1, y1, x2, y2, color, thickness=1):
    b, g, r = (int(c) for c in color)
    _load().shim_draw_line(_ptr(img), img.shape[0], img.shape[1],
                           int(x1), int(y1), int(x2), int(y2), b, g, r,
                           int(thickness))


def draw_polyline(img, pts, color, thickness=1, closed=True):
    pts = np.ascontiguousarray(np.asarray(pts, np.int32).reshape(-1, 2))
    b, g, r = (int(c) for c in color)
    _load().shim_draw_polyline(_ptr(img), img.shape[0], img.shape[1],
                               _iptr(pts), len(pts), int(closed), b, g, r,
                               int(thickness))


def fill_poly(img, pts, color):
    pts = np.ascontiguousarray(np.asarray(pts, np.int32).reshape(-1, 2))
    b, g, r = (int(c) for c in color)
    _load().shim_fill_poly(_ptr(img), img.shape[0], img.shape[1], _iptr(pts),
                           len(pts), b, g, r)


def blend(dst, src, wa, wb):
    """dst = dst*wa + src*wb, in place (cv2.addWeighted)."""
    assert dst.shape == src.shape
    _load().shim_blend(_ptr(dst), _ptr(src), dst.size, float(wa), float(wb))


def draw_text(img, text, x, y, color, scale=1):
    b, g, r = (int(c) for c in color)
    _load().shim_draw_text(_ptr(img), img.shape[0], img.shape[1], int(x),
                           int(y), text.encode(), int(scale), b, g, r)


def text_size(text, scale=1):
    w = ctypes.c_int()
    h = ctypes.c_int()
    _load().shim_text_size(text.encode(), int(scale), ctypes.byref(w),
                           ctypes.byref(h))
    return w.value, h.value
