"""ctypes bindings of the native libav shims: the decoder
(``native/video_decoder.cpp``) and the mp4 encoder
(``native/video_encoder.cpp``).

Counterpart of ``strongsort_yolo_tpu/media/native_decoder.py``, loading
the same prebuilt ``native/libvideo_decoder.so`` and
``native/libvideo_encoder.so`` by path; it never builds them. Where a
library does not load (its libav ``.so`` missing on this machine, say),
``decoder_error()`` / ``encoder_error()`` keep the loader's ``OSError``
text, which names the missing library, and the readers and writers
report ``ok == False``.

``NativeVideoReader`` has ``VideoReader``'s surface (width, height, fps,
ok, frame iteration, release); the decode runs in C and ctypes drops the
GIL around each ``vd_read``, so per-stream reader threads decode while
the card computes. ``NativeVideoWriter`` writes MPEG-4 in mp4, the
reference's cv2 "mp4v" output (``yolo_multi_model.py:256-260``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
DECODER_PATH = os.path.join(NATIVE_DIR, "libvideo_decoder.so")
ENCODER_PATH = os.path.join(NATIVE_DIR, "libvideo_encoder.so")

# path -> (CDLL or None, error text or None); each library loads once
_loaded: dict[str, tuple[ctypes.CDLL | None, str | None]] = {}


def _open(path: str, bind) -> ctypes.CDLL | None:
    if path not in _loaded:
        if not os.path.exists(path):
            _loaded[path] = (None, f"{path}: no such file")
        else:
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                _loaded[path] = (None, str(e))
            else:
                bind(lib)
                _loaded[path] = (lib, None)
    return _loaded[path][0]


def _bind_decoder(lib) -> None:
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_info.restype = ctypes.c_int
    lib.vd_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.vd_read.restype = ctypes.c_int
    lib.vd_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.vd_close.restype = None
    lib.vd_close.argtypes = [ctypes.c_void_p]


def _bind_encoder(lib) -> None:
    lib.ve_open.restype = ctypes.c_void_p
    lib.ve_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ]
    lib.ve_write.restype = ctypes.c_int
    lib.ve_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ve_close.restype = ctypes.c_int
    lib.ve_close.argtypes = [ctypes.c_void_p]


def _decoder():
    return _open(DECODER_PATH, _bind_decoder)


def _encoder():
    return _open(ENCODER_PATH, _bind_encoder)


def available() -> bool:
    """Whether the decoder library loads."""
    return _decoder() is not None


def encoder_available() -> bool:
    """Whether the encoder library loads."""
    return _encoder() is not None


def decoder_error() -> str | None:
    """The decoder's load error (None when it loads)."""
    _decoder()
    return _loaded[DECODER_PATH][1]


def encoder_error() -> str | None:
    """The encoder's load error (None when it loads)."""
    _encoder()
    return _loaded[ENCODER_PATH][1]


class NativeVideoReader:
    """BGR frame iterator over a video file via the C decode shim."""

    def __init__(self, source: str):
        self.source = str(source)
        lib = _decoder()
        self._lib = lib
        self._h = None
        self.width = self.height = 0
        self.fps = 30.0
        self.nframes = 0
        if lib is None:
            return
        h = lib.vd_open(self.source.encode())
        if not h:
            return
        self._h = h
        w = ctypes.c_int()
        hh = ctypes.c_int()
        fps = ctypes.c_double()
        n = ctypes.c_long()
        lib.vd_info(h, ctypes.byref(w), ctypes.byref(hh), ctypes.byref(fps),
                    ctypes.byref(n))
        self.width = w.value
        self.height = hh.value
        self.fps = fps.value or 30.0
        self.nframes = n.value

    @property
    def ok(self) -> bool:
        return self._h is not None

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._h is None:
            return
        buf = np.empty((self.height, self.width, 3), np.uint8)
        while True:
            r = self._lib.vd_read(self._h, buf.ctypes.data_as(ctypes.c_void_p))
            if r != 1:
                break
            yield buf.copy()

    def release(self):
        if self._h is not None:
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class NativeVideoWriter:
    """mp4 (MPEG-4) writer via the C encode shim, with ``VideoWriter``'s
    surface."""

    def __init__(self, path: str, width: int, height: int, fps: float = 15.0):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lib = _encoder()
        self._h = None
        self.width, self.height = width, height
        if self._lib is not None:
            self._h = self._lib.ve_open(
                path.encode(), int(width), int(height), float(fps)
            )

    @property
    def ok(self) -> bool:
        return self._h is not None

    def write(self, frame: np.ndarray):
        if self._h is None:
            return
        frame = np.ascontiguousarray(frame, np.uint8)
        self._lib.ve_write(self._h, frame.ctypes.data_as(ctypes.c_void_p))

    def release(self):
        if self._h is not None:
            self._lib.ve_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass
