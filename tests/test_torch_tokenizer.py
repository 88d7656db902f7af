"""The port's byte-level BPE tokenizer and corpus datasets
(``tpujob_torch.workloads.tokenizer``, ``data.byte_token_dataset``,
``data.bpe_token_dataset``) against the JAX package's copies.

Both are numpy only, so everything here is held exactly: the same merges,
the same ids, the same JSON file byte for byte, the same token sidecar
(name and digest included, so the two packages share one cache) and the
same memory-mapped chunks.  A hypothesis case draws random byte strings,
runs of one byte among them (the a == b overlap rule of ``_apply_merge``).
"""
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpujob.workloads import data as jdata
from tpujob.workloads import tokenizer as jtok
from tpujob_torch.workloads import data as tdata
from tpujob_torch.workloads import tokenizer as ttok

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus() -> bytes:
    """Real text: this repository's JAX tokenizer and data modules."""
    out = b""
    for name in ("tokenizer.py", "data.py"):
        with open(os.path.join(ROOT, "tpujob", "workloads", name), "rb") as f:
            out += f.read()
    return out


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "corpus.txt"
    path.write_bytes(_corpus())
    return str(path)


@pytest.mark.parametrize("vocab", [256, 300, 420])
def test_train_gives_the_same_merges(vocab):
    data = _corpus()
    got = ttok.BPETokenizer.train(data, vocab)
    want = jtok.BPETokenizer.train(data, vocab)
    assert got.merges == want.merges
    assert got.vocab_size == want.vocab_size == vocab


@pytest.mark.parametrize("max_bytes", [1000, 20_000])
def test_train_samples_max_bytes_alike(max_bytes):
    data = _corpus()
    got = ttok.BPETokenizer.train(data, 320, max_bytes=max_bytes)
    want = jtok.BPETokenizer.train(data, 320, max_bytes=max_bytes)
    assert got.merges == want.merges


def test_encode_decode_match_jax():
    data = _corpus()
    merges = jtok.BPETokenizer.train(data, 380).merges
    got, want = ttok.BPETokenizer(merges), jtok.BPETokenizer(merges)
    ids = got.encode(data)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, want.encode(data))
    assert got.decode(ids) == want.decode(ids) == data
    assert len(ids) < len(data)  # the merges compress


def test_saved_json_is_byte_identical(tmp_path):
    merges = jtok.BPETokenizer.train(_corpus(), 300).merges
    ttok.BPETokenizer(merges).save(str(tmp_path / "t.json"))
    jtok.BPETokenizer(merges).save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    # each package loads the other's file
    assert ttok.BPETokenizer.load(str(tmp_path / "j.json")).merges == merges
    assert jtok.BPETokenizer.load(str(tmp_path / "t.json")).merges == merges
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_load_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 2, "vocab_size": 256, "merges": []}))
    with pytest.raises(ValueError, match="unsupported tokenizer format"):
        ttok.BPETokenizer.load(str(bad))
    bad.write_text(json.dumps({"version": 1, "vocab_size": 300,
                               "merges": [[1, 2]]}))
    with pytest.raises(ValueError, match="does not match"):
        ttok.BPETokenizer.load(str(bad))


def test_train_and_decode_errors():
    with pytest.raises(ValueError, match="vocab_size must be >= 256"):
        ttok.BPETokenizer.train(b"abc", 100)
    with pytest.raises(ValueError, match="outside vocab"):
        ttok.BPETokenizer([(97, 98)]).decode([257])


def test_load_or_train_trains_once_then_loads(tmp_path, corpus_file, capsys):
    path = str(tmp_path / "tok.json")
    tok = ttok.load_or_train(path, corpus_file, 290)
    assert "trained BPE tokenizer (290 ids)" in capsys.readouterr().out
    assert tok.merges == jtok.load_or_train(
        str(tmp_path / "j.json"), corpus_file, 290, verbose=False).merges
    again = ttok.load_or_train(path, corpus_file, 999)  # exists: loaded
    assert again.merges == tok.merges


def test_cli_train_and_inspect(tmp_path, corpus_file, capsys):
    out = str(tmp_path / "cli.json")
    assert ttok.main(["train", "--input", corpus_file, "--vocab-size", "270",
                      "--out", out]) == 0
    assert "trained 270-id tokenizer (14 merges)" in capsys.readouterr().out
    assert ttok.main(["inspect", "--tokenizer", out, "--sample",
                      "def train"]) == 0
    text = capsys.readouterr().out
    assert "vocab_size=270 merges=14" in text
    assert "round-trip: 'def train'" in text


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.binary(min_size=0, max_size=40),
                          st.tuples(st.integers(0, 255),
                                    st.integers(1, 12)).map(
                              lambda t: bytes([t[0]]) * t[1])),
                min_size=1, max_size=12).map(b"".join),
       st.integers(256, 300))
def test_random_bytes_match_jax(data, vocab):
    """Merges, ids and the round trip on random bytes with runs of one
    byte (where a pair (a, a) overlaps itself)."""
    got = ttok.BPETokenizer.train(data, vocab)
    want = jtok.BPETokenizer.train(data, vocab)
    assert got.merges == want.merges
    ids = got.encode(data)
    np.testing.assert_array_equal(ids, want.encode(data))
    assert got.decode(ids) == data


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 3), min_size=0, max_size=30),
       st.integers(0, 3), st.integers(0, 3))
def test_apply_merge_matches_jax(toks, a, b):
    arr = np.asarray(toks, dtype=np.int64)
    np.testing.assert_array_equal(ttok._apply_merge(arr, a, b, 9),
                                  jtok._apply_merge(arr, a, b, 9))


def test_apply_merge_runs_left_to_right():
    arr = np.array([5, 5, 5, 1, 5, 5, 5, 5], dtype=np.int64)
    np.testing.assert_array_equal(ttok._apply_merge(arr, 5, 5, 9),
                                  [9, 5, 1, 9, 9])


@pytest.mark.parametrize("seq_len", [64, 100, 1])
def test_byte_token_dataset_matches_jax(corpus_file, seq_len):
    got = tdata.byte_token_dataset(corpus_file, seq_len)
    want = jdata.byte_token_dataset(corpus_file, seq_len)
    assert isinstance(got.base, np.memmap) or isinstance(got, np.memmap)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_short_corpus_raises(tmp_path):
    short = tmp_path / "short.txt"
    short.write_bytes(b"abc")
    with pytest.raises(ValueError, match="shorter than one"):
        tdata.byte_token_dataset(str(short), 8)
    with pytest.raises(ValueError, match="shorter than one"):
        tdata.bpe_token_dataset(str(short), 8, ttok.BPETokenizer([]))


@pytest.mark.parametrize("vocab", [300, 70_000])
def test_bpe_sidecar_is_shared_with_jax(tmp_path, vocab):
    """The port writes the sidecar under the JAX package's name (digest of
    the merges and of the corpus' size and mtime); the JAX package then
    reads the port's cache instead of encoding anew, and both see the same
    chunks.  Above 65,535 ids the cache is uint32."""
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(_corpus())
    merges = jtok.BPETokenizer.train(_corpus(), 300).merges
    # a vocabulary past uint16: pad the merge list with a merge that never
    # matches (the text holds no NUL byte)
    merges = merges + [(0, 0)] * (vocab - 300)
    got = tdata.bpe_token_dataset(str(corpus), 32, ttok.BPETokenizer(merges))
    sidecars = [p for p in os.listdir(tmp_path) if p.endswith(".tokens")]
    assert len(sidecars) == 1 and sidecars[0].startswith(f"c.txt.bpe{vocab}-")
    want = jdata.bpe_token_dataset(str(corpus), 32, jtok.BPETokenizer(merges))
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tokens")] == \
        sidecars  # no second cache
    assert got.dtype == (np.uint16 if vocab <= 65535 else np.uint32)
    np.testing.assert_array_equal(got, want)
    ids = ttok.BPETokenizer(merges).encode(_corpus())
    np.testing.assert_array_equal(
        got.reshape(-1), ids[: got.size].astype(got.dtype))


def test_bpe_sidecar_follows_the_corpus_and_tokenizer(tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(_corpus())
    merges = jtok.BPETokenizer.train(_corpus(), 280).merges

    def sidecars():
        return sorted(p for p in os.listdir(tmp_path) if p.endswith(".tokens"))

    tdata.bpe_token_dataset(str(corpus), 16, ttok.BPETokenizer(merges))
    first = sidecars()
    assert len(first) == 1
    # an edited corpus gets a new digest, so a new cache
    corpus.write_bytes(_corpus() + b"more")
    tdata.bpe_token_dataset(str(corpus), 16, ttok.BPETokenizer(merges))
    assert len(sidecars()) == 2
    # so does another tokenizer
    tdata.bpe_token_dataset(str(corpus), 16, ttok.BPETokenizer(merges[:-1]))
    assert len(sidecars()) == 3
