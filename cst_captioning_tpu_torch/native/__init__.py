"""Native (C++) CIDEr-D scorer and PTB tokenizer (own copy of the
reference's ``native/__init__.py`` and its two sources).

The host-reward CST path scores every sampled and baseline caption once
per step.  ``NativeCiderD`` keeps that work in C++ and reads the token-id
rows of the rollout directly: no id -> string -> split round trip.
``ptb_tokenize_batch`` is the C++ twin of ``metrics/tokenizer.py`` for a
whole corpus in one call.

Build: g++ compiles each source at its first use into
``cst_captioning_tpu_torch/build/lib<name>-<digest>.so``, where the
digest covers the source, the flags, the compiler's version and the
platform (machine and C library), so an edited source is rebuilt and a
library built by another compiler or for another platform is never
loaded (``ops/_cuda.py`` keys the CUDA kernels on their sources).  The compiler writes a per-process temporary file that
is renamed into place, so processes building at once never load a
half-written library.  Nothing is written beside the sources.  Callers
that must run without a toolchain catch ``NativeUnavailable`` and use the
pure-Python scorer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import sysconfig
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..utils.locksan import named_lock

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "build"
CIDERD_SRC = _DIR / "ciderd.cpp"
TOKENIZER_SRC = _DIR / "tokenizer.cpp"

# No -march=native: a host-specific ISA would SIGILL (uncatchable) if a
# built library were ever loaded on another machine.
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# One lock for building and loading both libraries: two threads racing a
# first use never build twice or load a half-written library.
_lock = named_lock("native.build")
_loaded: Dict[str, ctypes.CDLL] = {}  # cstlint-torch: guarded_by=_lock
#: Seconds g++ took for each library this process built (by source stem);
#: a library found built already is not in it.
BUILD_SECONDS: Dict[str, float] = {}


class NativeUnavailable(RuntimeError):
    """The shared library cannot be built or loaded."""


def toolchain_id() -> str:
    """The compiler and the platform a library is built with and for: the
    g++ on ``PATH`` and its version, the platform tag and the C library.
    Raises ``NativeUnavailable`` without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable("g++ not available")
    return " ".join([f"g++ {_gxx_version(gxx)}", sysconfig.get_platform(),
                     *platform.libc_ver()])


@functools.lru_cache(maxsize=None)
def _gxx_version(gxx: str) -> str:
    try:
        return subprocess.run([gxx, "-dumpfullversion", "-dumpversion"],
                              check=True, capture_output=True,
                              text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeUnavailable(f"g++ at {gxx} does not run: {e}") from e


def library_path(src: Path, build_dir: Path = BUILD_DIR) -> Path:
    """``build_dir/lib<stem>-<digest>.so``: digest of the flags, the
    toolchain (``toolchain_id``) and the source."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(toolchain_id().encode())
    digest.update(Path(src).read_bytes())
    return Path(build_dir) / f"lib{Path(src).stem}-{digest.hexdigest()[:16]}.so"


def build_library(src: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` unless its library is built; -> the library's
    path.  Raises ``NativeUnavailable`` without g++ or on a failed
    build."""
    dest = library_path(src, build_dir)
    if dest.exists():
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_name(f"{dest.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, dest)
        BUILD_SECONDS[Path(src).stem] = time.perf_counter() - t0
    except FileNotFoundError as e:
        raise NativeUnavailable("g++ not available") from e
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(f"native build failed:\n{e.stderr}") from e
    finally:
        if tmp.exists():
            tmp.unlink()
    return dest


def _load(src: Path, declare) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``src`` once per
    process, with ``declare(lib)`` setting its ctypes signatures."""
    with _lock:
        lib = _loaded.get(src.stem)
        if lib is None:
            path = build_library(src)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeUnavailable(f"cannot load {path}: {e}") from e
            declare(lib)
            _loaded[src.stem] = lib
        return lib


def _declare_ciderd(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ciderd_new.restype = ctypes.c_void_p
    lib.ciderd_new.argtypes = [ctypes.c_int, ctypes.c_double]
    lib.ciderd_free.restype = None
    lib.ciderd_free.argtypes = [ctypes.c_void_p]
    lib.ciderd_add_video.restype = None
    lib.ciderd_add_video.argtypes = [ctypes.c_void_p, i32p, i32p,
                                     ctypes.c_int]
    lib.ciderd_finalize.restype = None
    lib.ciderd_finalize.argtypes = [ctypes.c_void_p]
    lib.ciderd_num_videos.restype = ctypes.c_int
    lib.ciderd_num_videos.argtypes = [ctypes.c_void_p]
    lib.ciderd_score.restype = ctypes.c_int
    lib.ciderd_score.argtypes = [ctypes.c_void_p, i32p, i32p, ctypes.c_int,
                                 ctypes.c_int, f64p]
    lib.ciderd_score_loo.restype = ctypes.c_int
    lib.ciderd_score_loo.argtypes = [ctypes.c_void_p, ctypes.c_int, f64p]
    lib.ciderd_num_refs.restype = ctypes.c_int
    lib.ciderd_num_refs.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ciderd_set_df.restype = ctypes.c_int
    lib.ciderd_set_df.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint64), f64p,
                                  ctypes.c_int, ctypes.c_double]


def _declare_tokenizer(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ptb_tokenize.restype = ctypes.c_int
    lib.ptb_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int]
    lib.ptb_tokenize_batch.restype = ctypes.c_int
    lib.ptb_tokenize_batch.argtypes = [ctypes.c_char_p, i32p, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_int, i32p]


def load_library() -> ctypes.CDLL:
    """The CIDEr-D library, built at first use."""
    return _load(CIDERD_SRC, _declare_ciderd)


def load_tokenizer_library() -> ctypes.CDLL:
    """The PTB tokenizer library, built at first use."""
    return _load(TOKENIZER_SRC, _declare_tokenizer)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


_U64 = (1 << 64) - 1


def fnv_ngram_hash(ids) -> int:
    """Python replica of ciderd.cpp's ``ngram_hash`` (FNV-1a over
    (order, ids...)): an external df table hashes into the same buckets
    as the library's own cooking."""
    h = (1469598103934665603 ^ len(ids)) & _U64
    for i in ids:
        h ^= ((int(i) & 0xFFFFFFFF) + 0x9E3779B9) & _U64
        h = (h * 1099511628211) & _U64
    return h


class NativeCiderD:
    """Corpus-df CIDEr-D over token ids, references fixed at construction.

    Args:
      tokenized_refs: ``{video_id: [tokenized caption string, ...]}``, the
        training references; they define the document frequencies.
      word_to_ix: the model vocabulary's word -> id map.  Reference words
        outside it get fresh ids here: they never match a hypothesis (whose
        ids come from the model vocabulary) but count in the reference
        norms and the df, as in the string scorer.
    """

    def __init__(self, tokenized_refs: Mapping[str, Sequence[str]],
                 word_to_ix: Optional[Mapping[str, int]] = None,
                 n: int = 4, sigma: float = 6.0):
        self._lib = load_library()
        self.n = n
        self.sigma = sigma
        self._w2i: Dict[str, int] = dict(word_to_ix or {})
        self._next_id = max(self._w2i.values(), default=0) + 1
        self._video_ix: Dict[str, int] = {}
        self._handle = self._lib.ciderd_new(n, sigma)
        try:
            for vid, caps in tokenized_refs.items():
                rows = [self._encode(c) for c in caps]
                lens = np.asarray([len(r) for r in rows], dtype=np.int32)
                flat = (np.concatenate(rows).astype(np.int32)
                        if rows else np.zeros(0, np.int32))
                self._lib.ciderd_add_video(self._handle, _i32p(flat),
                                           _i32p(lens), len(rows))
                self._video_ix[vid] = len(self._video_ix)
            self._lib.ciderd_finalize(self._handle)
        except BaseException:
            self.close()
            raise

    def _word_id(self, w: str) -> int:
        ix = self._w2i.get(w)
        if ix is None:
            ix = self._next_id
            self._w2i[w] = ix
            self._next_id += 1
        return ix

    def _encode(self, caption: str) -> np.ndarray:
        return np.asarray([self._word_id(w) for w in caption.split()],
                          dtype=np.int32)

    def load_df(self, df: Mapping[tuple, float], ref_len: float) -> None:
        """Install an external document-frequency table (``{n-gram word
        tuple: document count}`` over ``ref_len`` documents, the format of
        the reference's ``metrics.ciderd.load_corpus_df``) in place of the
        one built from the references, and rebuild their TF-IDF
        vectors."""
        hashes = np.asarray(
            [fnv_ngram_hash([self._word_id(w) for w in ng]) for ng in df],
            dtype=np.uint64)
        counts = np.asarray(list(df.values()), dtype=np.float64)
        rc = self._lib.ciderd_set_df(
            self._handle,
            hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            _f64p(counts), len(hashes), float(ref_len))
        if rc != 0:
            raise RuntimeError(f"ciderd_set_df failed with code {rc}")

    def score_ids(self, video_ids: Sequence[str],
                  hyps: np.ndarray) -> np.ndarray:
        """Score 0-terminated id rows (N, L).  N is a multiple of
        ``len(video_ids)`` and the rows are grouped per video (the rollout
        layout): row i belongs to ``video_ids[i // (N // len(video_ids))]``."""
        hyps = np.ascontiguousarray(hyps, dtype=np.int32)
        if hyps.ndim != 2:
            raise ValueError(f"hypotheses must be (N, L), got {hyps.shape}")
        n_hyps, max_len = hyps.shape
        if not video_ids or n_hyps % len(video_ids):
            raise ValueError(
                f"{n_hyps} hypothesis rows not a multiple of "
                f"{len(video_ids)} videos; rows must be grouped per video")
        per_vid = n_hyps // len(video_ids)
        ix = np.asarray([self._video_ix[video_ids[i // per_vid]]
                         for i in range(n_hyps)], dtype=np.int32)
        out = np.zeros(n_hyps, dtype=np.float64)
        rc = self._lib.ciderd_score(self._handle, _i32p(ix), _i32p(hyps),
                                    max_len, n_hyps, _f64p(out))
        if rc != 0:
            raise RuntimeError(f"ciderd_score failed with code {rc}")
        return out

    def score_strings(self, video_ids: Sequence[str],
                      captions: Sequence[str]) -> np.ndarray:
        """Tokenized caption strings -> scores (through ``score_ids``)."""
        rows = [self._encode(c) for c in captions]
        max_len = max((len(r) for r in rows), default=0) + 1
        mat = np.zeros((len(rows), max_len), dtype=np.int32)
        for i, r in enumerate(rows):
            mat[i, :len(r)] = r
        return self.score_ids(video_ids, mat)

    def consensus_scores(self) -> Dict[str, np.ndarray]:
        """Leave-one-out CIDEr-D of every reference against its siblings,
        for every video (``metrics.consensus.compute_consensus_scores``'s
        numbers)."""
        out: Dict[str, np.ndarray] = {}
        for vid, v in self._video_ix.items():
            r = int(self._lib.ciderd_num_refs(self._handle, v))
            buf = np.zeros(max(r, 1), dtype=np.float64)
            rc = self._lib.ciderd_score_loo(self._handle, v, _f64p(buf))
            if rc != 0:
                raise RuntimeError(f"ciderd_score_loo failed with code {rc}")
            out[vid] = buf[:r] if r else np.zeros(1)
        return out

    @property
    def num_videos(self) -> int:
        return int(self._lib.ciderd_num_videos(self._handle))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ciderd_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def ptb_tokenize_batch(captions: Sequence[str]) -> List[str]:
    """C++ twin of ``[metrics.tokenizer.tokenize_to_str(c) for c in
    captions]`` in one call.  ASCII only: raises ``ValueError`` for
    non-ASCII input or a batch too large for the C interface's int32
    offsets, ``NativeUnavailable`` when the library cannot be built."""
    if not captions:
        return []
    encoded = []
    for c in captions:
        if not c.isascii():
            raise ValueError("native tokenizer is ASCII-only")
        encoded.append(c.encode("ascii"))
    total = sum(len(e) for e in encoded)
    cap = max(2 * total + 64 * len(encoded), 256)
    if cap > np.iinfo(np.int32).max:
        raise ValueError(
            f"native tokenizer batch too large for int32 offsets ({total} "
            f"input bytes, {cap} output capacity); split the batch")
    lib = load_tokenizer_library()
    offs = np.zeros(len(encoded) + 1, dtype=np.int32)
    np.cumsum([len(e) for e in encoded], out=offs[1:])
    out = ctypes.create_string_buffer(cap)
    out_offs = np.zeros(len(encoded) + 1, dtype=np.int32)
    n = lib.ptb_tokenize_batch(b"".join(encoded), _i32p(offs), len(encoded),
                               out, cap, _i32p(out_offs))
    if n < 0:
        raise NativeUnavailable("tokenizer output buffer overflow")
    raw = out.raw
    return [raw[out_offs[i]:out_offs[i + 1]].decode("ascii")
            for i in range(len(encoded))]
