"""Training data: the port's copy of ``tpujob/workloads/data.py`` (numpy).

Everything is made or read on the host with numpy, so the port and the JAX
package see the same arrays for the same seed or file:

- MNIST: a deterministic synthetic set with MNIST's shape and ten
  learnable classes (the default, no download), the IDX files of
  torchvision's on-disk layout when present, or the UCI handwritten digits
  from scikit-learn.  Images are NHWC float32, normalised.
- ``synthetic_imagenet_batch`` for ResNet, ``synthetic_token_batch`` for
  the transformers.
- Real corpora: ``byte_token_dataset`` (the file's raw bytes) and
  ``bpe_token_dataset`` (BPE tokens cached beside the corpus), both
  memory-mapped [n, seq_len] chunks.
"""
from __future__ import annotations

import gzip
import hashlib
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

# the reference example's normalisation constants
MEAN, STD = 0.1307, 0.3081

IMAGE_SHAPE = (28, 28, 1)  # NHWC, as the JAX package feeds it
NUM_CLASSES = 10


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
                 13: np.float32}[magic[1]]
        dims = struct.unpack(">" + "I" * magic[2], f.read(4 * magic[2]))
        return np.frombuffer(f.read(), dtype=dtype).reshape(dims)


def _find_idx(data_dir: str, stem: str) -> Optional[str]:
    for sub in ("", "FashionMNIST/raw", "MNIST/raw"):
        for ext in ("", ".gz"):
            p = os.path.join(data_dir, sub, stem + ext)
            if os.path.exists(p):
                return p
    return None


def synthetic_split(n: int, seed: int, noise: float = 0.2
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional synthetic images: each class a fixed random 28x28
    template, each sample its template plus gaussian noise, clipped to
    [0, 1]; separable enough that the reference CNN learns it in one
    epoch."""
    rng = np.random.RandomState(1234)  # templates shared across splits
    templates = rng.rand(NUM_CLASSES, 28, 28).astype(np.float32)
    rng2 = np.random.RandomState(seed)
    labels = rng2.randint(0, NUM_CLASSES, size=n).astype(np.int32)
    images = templates[labels] + noise * rng2.randn(n, 28, 28).astype(np.float32)
    images = np.clip(images, 0.0, 1.0)
    return images[..., None], labels


def _load_idx_splits(data_dir: str):
    ti = _find_idx(data_dir, "train-images-idx3-ubyte")
    tl = _find_idx(data_dir, "train-labels-idx1-ubyte")
    vi = _find_idx(data_dir, "t10k-images-idx3-ubyte")
    vl = _find_idx(data_dir, "t10k-labels-idx1-ubyte")
    if not (ti and tl and vi and vl):
        return None
    tx = _read_idx(ti).astype(np.float32)[..., None] / 255.0
    vx = _read_idx(vi).astype(np.float32)[..., None] / 255.0
    ty = _read_idx(tl).astype(np.int32)
    vy = _read_idx(vl).astype(np.int32)
    return (tx - MEAN) / STD, ty, (vx - MEAN) / STD, vy


def digits_datasets(train_size: int = 1500
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The UCI handwritten digits (scikit-learn's copy, 1,797 real images,
    no download): 8x8 greyscale upscaled 3x and padded to 28x28 so the
    MNIST CNN runs unchanged.  Needs scikit-learn; without it this raises
    (it never serves synthetic data in its place)."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError(
            "--dataset digits needs scikit-learn, which is not installed "
            "here; use --dataset synthetic or --dataset idx --data-dir DIR"
        ) from e

    d = load_digits()
    x = d.images.astype(np.float32) / 16.0
    x = np.repeat(np.repeat(x, 3, axis=1), 3, axis=2)  # 8x8 -> 24x24
    x = np.pad(x, ((0, 0), (2, 2), (2, 2)))[..., None]  # -> 28x28 NHWC
    y = d.target.astype(np.int32)
    idx = np.arange(len(x))
    np.random.RandomState(0).shuffle(idx)
    x = (x - MEAN) / STD
    train_size = min(train_size, len(x) - 64)  # keep a real test split
    tr, te = idx[:train_size], idx[train_size:]
    return x[tr], y[tr], x[te], y[te]


_IDX_STEMS = (
    "train-images-idx3-ubyte",
    "train-labels-idx1-ubyte",
    "t10k-images-idx3-ubyte",
    "t10k-labels-idx1-ubyte",
)


def resolve_dataset(data_dir: Optional[str], dataset: str = "auto") -> str:
    """Which set ``mnist_datasets`` serves: the explicit choice, or for
    ``auto`` a COMPLETE IDX set under ``data_dir`` (all four files), else
    synthetic."""
    if dataset in ("idx", "digits", "synthetic"):
        return dataset
    if data_dir and all(_find_idx(data_dir, stem) for stem in _IDX_STEMS):
        return "idx"
    return "synthetic"


def mnist_datasets(data_dir: Optional[str] = None, train_size: int = 60000,
                   test_size: int = 10000, dataset: str = "auto"
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_x, train_y, test_x, test_y), normalised, NHWC float32.
    ``dataset``: ``auto``, ``idx``, ``digits`` or ``synthetic``."""
    resolved = resolve_dataset(data_dir, dataset)
    if resolved == "idx":
        splits = _load_idx_splits(data_dir) if data_dir else None
        if splits is None:
            raise FileNotFoundError(
                f"dataset 'idx' requested but no IDX files under {data_dir!r}")
        return splits
    if resolved == "digits":
        return digits_datasets(train_size)
    tx, ty = synthetic_split(train_size, seed=0)
    vx, vy = synthetic_split(test_size, seed=1)
    return (tx - MEAN) / STD, ty, (vx - MEAN) / STD, vy


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, *, seed: int = 0,
            shuffle: bool = True, drop_remainder: bool = True
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of (x, y) batches in a seeded order (the DataLoader's
    part); the ragged tail is dropped by default, so every step has one
    shape."""
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    end = n - n % batch_size if drop_remainder else n
    for start in range(0, end, batch_size):
        sel = idx[start : start + batch_size]
        yield x[sel], y[sel]


def synthetic_imagenet_batch(batch: int, image_size: int = 224, seed: int = 0):
    """A deterministic ImageNet-shaped NHWC batch and its labels."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, image_size, image_size, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=batch).astype(np.int32)
    return x, y


def synthetic_token_batch(batch: int, seq_len: int, vocab: int = 30522, seed: int = 0):
    """A deterministic [batch, seq_len] int32 token batch."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(batch, seq_len)).astype(np.int32)
    return ids


def byte_token_dataset(path: str, seq_len: int) -> np.ndarray:
    """A file's raw bytes as [n, seq_len] token ids (vocab 256): any file is
    a corpus, with no tokenizer.

    The array is a memory-mapped uint8 view: the corpus costs no host
    memory until rows are sliced (``chunks[idx]`` reads only those rows).
    Callers convert the sliced batch to int at feed time."""
    size = os.path.getsize(path)
    n = size // seq_len
    if n == 0:
        raise ValueError(
            f"{path!r} holds {size} bytes — shorter than one "
            f"seq_len={seq_len} chunk")
    raw = np.memmap(path, dtype=np.uint8, mode="r", shape=(n * seq_len,))
    return raw.reshape(n, seq_len)


def bpe_token_dataset(path: str, seq_len: int, tokenizer) -> np.ndarray:
    """A BPE-tokenized corpus as memory-mapped [n, seq_len] chunks.

    The corpus is encoded once into a sidecar token file beside it (uint16
    when the vocabulary fits, else uint32) and memory-mapped after that.
    The sidecar's name carries a digest of the tokenizer's merges and of the
    corpus' size and mtime, so a changed corpus or tokenizer makes a new
    cache.  The name is the JAX package's, digest included: the two share
    one cache."""
    v = tokenizer.vocab_size
    dtype = np.uint16 if v <= np.iinfo(np.uint16).max else np.uint32
    st = os.stat(path)
    key = hashlib.sha1(
        repr((tokenizer.merges, st.st_size, st.st_mtime_ns)).encode()
    ).hexdigest()[:12]
    sidecar = f"{path}.bpe{v}-{key}.tokens"
    if not os.path.exists(sidecar):
        with open(path, "rb") as f:
            ids = tokenizer.encode(f.read())
        # a temporary name per process and an atomic rename: processes
        # building the same cache race benignly
        tmp = f"{sidecar}.{os.getpid()}.tmp"
        ids.astype(dtype).tofile(tmp)
        os.replace(tmp, sidecar)
    count = os.path.getsize(sidecar) // np.dtype(dtype).itemsize
    n = count // seq_len
    if n == 0:
        raise ValueError(
            f"{path!r} encodes to {count} BPE tokens — shorter than one "
            f"seq_len={seq_len} chunk")
    toks = np.memmap(sidecar, dtype=dtype, mode="r", shape=(n * seq_len,))
    return toks.reshape(n, seq_len)
