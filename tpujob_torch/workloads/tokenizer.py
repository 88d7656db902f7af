"""Byte-level BPE tokenizer: the port's copy of
``tpujob/workloads/tokenizer.py`` (numpy only, no torch needed).

GPT-2-style: 256 base byte tokens plus learned merges, trained and applied
with vectorised numpy passes, so a corpus is tokenized without a download
or native code.  It gives the same merges, the same ids and the same JSON
file as the JAX package's, so a tokenizer trained by either loads in the
other and the two share one token cache (``data.bpe_token_dataset``).

- **Training** samples at most ``max_bytes`` of the corpus, counts
  adjacent pairs with one ``np.unique`` a merge and records merges in rank
  order; ties break on the smaller packed pair id (deterministic).
- **Encoding** applies merges rank by rank, one masked merge pass each.
- **Format**: one JSON file, ``{"version", "vocab_size", "merges"}``:
  merge i makes token id 256+i from the pair ``merges[i]``.

CLI:
    python -m tpujob_torch.workloads.tokenizer train --input corpus.txt \
        --vocab-size 512 --out tok.json
    python -m tpujob_torch.workloads.tokenizer inspect --tokenizer tok.json \
        [--sample "text"]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Sequence, Tuple

import numpy as np


def _apply_merge(toks: np.ndarray, a: int, b: int, new_id: int) -> np.ndarray:
    """One vectorised merge pass: every non-overlapping (a, b) pair becomes
    ``new_id``.  Overlaps (only when a == b) resolve left to right, as the
    sequential algorithm does."""
    if len(toks) < 2:
        return toks
    match = (toks[:-1] == a) & (toks[1:] == b)
    if not match.any():
        return toks
    idx = np.flatnonzero(match)
    if a == b:
        # a run [a a a] matches at consecutive positions but only every
        # other one may merge: greedy left to right over the match list
        keep = []
        last = -2
        for i in idx:
            if i == last + 1:
                continue  # overlaps the merge kept before it
            keep.append(i)
            last = i
        idx = np.asarray(keep, dtype=idx.dtype)
    out = toks.copy()
    out[idx] = new_id
    mask = np.ones(len(toks), dtype=bool)
    mask[idx + 1] = False
    return out[mask]


class BPETokenizer:
    """Byte-level BPE: ids [0, 256) are literal bytes; each merge adds one
    id.  ``vocab_size`` counts base bytes and merges."""

    def __init__(self, merges: Sequence[Tuple[int, int]]):
        self.merges: List[Tuple[int, int]] = [tuple(m) for m in merges]
        self.vocab_size = 256 + len(self.merges)

    @classmethod
    def train(cls, data: bytes, vocab_size: int,
              max_bytes: int = 2_000_000) -> "BPETokenizer":
        if vocab_size < 256:
            raise ValueError(
                f"vocab_size must be >= 256 (the byte alphabet), got "
                f"{vocab_size}")
        toks = np.frombuffer(data[:max_bytes], dtype=np.uint8).astype(np.int64)
        merges: List[Tuple[int, int]] = []
        while 256 + len(merges) < vocab_size and len(toks) >= 2:
            # adjacent-pair histogram in one pass; ties break on the
            # smaller packed pair id
            width = 256 + len(merges)
            codes = toks[:-1] * width + toks[1:]
            uniq, counts = np.unique(codes, return_counts=True)
            best = uniq[np.argmax(counts)]
            if counts.max() < 2:
                break  # nothing left worth merging
            a, b = int(best // width), int(best % width)
            new_id = 256 + len(merges)
            merges.append((a, b))
            toks = _apply_merge(toks, a, b, new_id)
        return cls(merges)

    def encode(self, data: bytes) -> np.ndarray:
        """bytes -> int32 token ids (one pass a merge)."""
        toks = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
        for rank, (a, b) in enumerate(self.merges):
            toks = _apply_merge(toks, a, b, 256 + rank)
        return toks.astype(np.int32)

    def decode(self, ids: Sequence[int]) -> bytes:
        """token ids -> bytes (an unknown id raises)."""
        table: List[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            table.append(table[a] + table[b])
        out = bytearray()
        for i in ids:
            i = int(i)
            if not 0 <= i < len(table):
                raise ValueError(
                    f"token id {i} outside vocab of {len(table)}")
            out += table[i]
        return bytes(out)

    def save(self, path: str) -> None:
        # write a temporary file and rename it: load_or_train's
        # exists-then-load must never see a half-written file
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "vocab_size": self.vocab_size,
                       "merges": [list(m) for m in self.merges]}, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            blob = json.load(f)
        if blob.get("version") != 1:
            raise ValueError(
                f"{path!r}: unsupported tokenizer format "
                f"{blob.get('version')!r}")
        tok = cls([tuple(m) for m in blob["merges"]])
        if tok.vocab_size != blob["vocab_size"]:
            raise ValueError(
                f"{path!r}: vocab_size {blob['vocab_size']} does not match "
                f"256 + {len(tok.merges)} merges")
        return tok


def load_or_train(path: str, corpus_path: str, vocab_size: int,
                  max_bytes: int = 2_000_000,
                  verbose: bool = True) -> BPETokenizer:
    """``--tokenizer bpe:PATH[:V]``: load PATH if it exists, else train on
    the corpus and save to PATH (deterministic, so every process trains the
    same tokenizer; the save is atomic)."""
    if os.path.exists(path):
        return BPETokenizer.load(path)
    with open(corpus_path, "rb") as f:
        data = f.read(max_bytes)  # train() samples this much anyway
    tok = BPETokenizer.train(data, vocab_size, max_bytes)
    tok.save(path)
    if verbose:
        print(f"trained BPE tokenizer ({tok.vocab_size} ids) on "
              f"{corpus_path} -> {path}")
    return tok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Byte-level BPE tokenizer (train / inspect)")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train on a corpus file")
    t.add_argument("--input", required=True)
    t.add_argument("--vocab-size", type=int, default=512)
    t.add_argument("--max-bytes", type=int, default=2_000_000,
                   help="sample at most this many corpus bytes for the "
                        "pair statistics")
    t.add_argument("--out", required=True)
    i = sub.add_parser("inspect", help="print tokenizer stats")
    i.add_argument("--tokenizer", required=True)
    i.add_argument("--sample", default=None,
                   help="round-trip this text and print the ids")
    args = p.parse_args(argv)
    if args.cmd == "train":
        with open(args.input, "rb") as f:
            data = f.read()
        tok = BPETokenizer.train(data, args.vocab_size, args.max_bytes)
        tok.save(args.out)
        print(f"trained {tok.vocab_size}-id tokenizer "
              f"({len(tok.merges)} merges) -> {args.out}")
    else:
        tok = BPETokenizer.load(args.tokenizer)
        print(f"{args.tokenizer}: vocab_size={tok.vocab_size} "
              f"merges={len(tok.merges)}")
        if args.sample is not None:
            ids = tok.encode(args.sample.encode())
            print(f"ids: {ids.tolist()}")
            print(f"round-trip: {tok.decode(ids).decode(errors='replace')!r}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
