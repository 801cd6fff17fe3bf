"""The port's data layer: each test of ``tests/test_data.py`` on the
port (tokenizer round trip, stream determinism, resume, file sharding,
epochs), and the port's ``TokenStream`` batches equal, exactly, to the
JAX package's over the same files."""
import numpy as np
import pytest

from repro.data import TokenStream as JTokenStream
from repro_torch.data import SamplerState, TokenStream, tokenizer as T


class TestTokenizer:
    def test_roundtrip(self):
        s = "ip.src|1.2.3.4 → port 6667 ✓"
        assert T.decode(T.encode(s)) == s

    def test_specials(self):
        ids = T.encode("x", add_bos=True, add_eos=True)
        assert ids[0] == T.BOS and ids[-1] == T.EOS
        assert T.decode(ids) == "x"


@pytest.fixture
def corpus(tmp_path):
    for i in range(3):
        (tmp_path / f"f{i}.txt").write_text(f"file{i} " * 200)
    return str(tmp_path / "*.txt")


class TestStream:
    def test_batch_shapes(self, corpus):
        st = TokenStream(corpus, seq_len=32, batch=2)
        b = st.next_batch()
        assert b["tokens"].shape == (2, 32)
        assert b["labels"].shape == (2, 32)
        assert b["tokens"].dtype == b["labels"].dtype == np.int32
        # labels are next-token shifted
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_deterministic(self, corpus):
        a = TokenStream(corpus, seq_len=16, batch=2).next_batch()
        b = TokenStream(corpus, seq_len=16, batch=2).next_batch()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_resume_from_state(self, corpus):
        s1 = TokenStream(corpus, seq_len=16, batch=2)
        for _ in range(3):
            s1.next_batch()
        saved = s1.state.to_dict()
        want = s1.next_batch()
        s2 = TokenStream(corpus, seq_len=16, batch=2,
                         state=SamplerState.from_dict(saved))
        got = s2.next_batch()
        np.testing.assert_array_equal(want["tokens"], got["tokens"])

    def test_sharding_disjoint_files(self, tmp_path):
        for i in range(4):
            (tmp_path / f"g{i}.txt").write_text(f"shard{i} " * 100)
        pattern = str(tmp_path / "*.txt")
        a = TokenStream(pattern, 16, 1, shard=0, n_shards=2)
        b = TokenStream(pattern, 16, 1, shard=1, n_shards=2)
        assert set(a.files).isdisjoint(b.files)
        assert set(a.files) | set(b.files) == set(
            TokenStream(pattern, 16, 1).files)

    def test_epoch_wraps(self, corpus):
        st = TokenStream(corpus, seq_len=512, batch=4)
        for _ in range(5):
            st.next_batch()
        assert st.state.epoch >= 1

    def test_no_files_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            TokenStream(str(tmp_path / "*.none"), 16, 1)


@pytest.mark.parametrize("shard", [0, 1])
def test_batches_match_jax(tmp_path, shard):
    """Twelve batches across file boundaries and an epoch wrap, and the
    sampler state after each, equal the JAX package's; a stream resumed
    from the JAX package's state continues as the JAX stream does."""
    for i in range(4):
        (tmp_path / f"h{i}.tsv").write_text(
            "\n".join(f"{i}\tip.src|10.0.{i}.{j}\tip.dst|1.2.3.{j % 7}"
                      for j in range(12 + 5 * i)))
    pattern = str(tmp_path / "*.tsv")
    mine = TokenStream(pattern, seq_len=64, batch=3, shard=shard, n_shards=2)
    ref = JTokenStream(pattern, seq_len=64, batch=3, shard=shard, n_shards=2)
    assert mine.files == ref.files
    for _ in range(12):
        a, b = mine.next_batch(), ref.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
        assert mine.state.to_dict() == ref.state.to_dict()
    assert mine.state.epoch >= 1
    resumed = TokenStream(pattern, seq_len=64, batch=3, shard=shard,
                          n_shards=2, state=SamplerState.from_dict(
                              ref.state.to_dict()))
    np.testing.assert_array_equal(resumed.next_batch()["tokens"],
                                  ref.next_batch()["tokens"])
