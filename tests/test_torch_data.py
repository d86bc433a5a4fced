"""The port's token stream (``repro_torch.runtime.data``) against the JAX
package's: batches bit-equal at several seeds, steps and host splits, and
the twins of ``TestDataPipeline`` (tests/test_runtime.py:88-126)."""
import numpy as np
import pytest

pytest.importorskip("torch")  # the port's package imports torch
pytest.importorskip("jax")  # the machine with the card has no JAX

from repro.runtime import data as jdata  # noqa: E402
from repro_torch.runtime.data import DataConfig, DataState, TokenStream  # noqa: E402


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("vocab,seq,batch,hosts", [(512, 32, 8, 1), (151936, 64, 4, 2),
                                                   (262144, 16, 6, 3)])
def test_batches_bit_equal_to_jax(seed, vocab, seq, batch, hosts):
    for host in range(hosts):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed,
                  n_hosts=hosts, host_id=host)
        ours, theirs = TokenStream(DataConfig(**kw)), jdata.TokenStream(jdata.DataConfig(**kw))
        for _ in range(4):
            a, b = ours.next(), theirs.next()
            assert a.keys() == b.keys() == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
        assert ours.state.as_dict() == theirs.state.as_dict() == {"step": 4}


def test_state_crosses_packages():
    """A data state saved by one package resumes the other's stream."""
    kw = dict(vocab_size=512, seq_len=16, global_batch=4, seed=3)
    theirs = jdata.TokenStream(jdata.DataConfig(**kw))
    for _ in range(3):
        theirs.next()
    ours = TokenStream(DataConfig(**kw), DataState.from_dict(theirs.state.as_dict()))
    np.testing.assert_array_equal(ours.next()["tokens"], theirs.next()["tokens"])


# ------------------------------------------ twins of TestDataPipeline --
class TestDataPipeline:
    def test_deterministic(self):
        cfg = DataConfig(vocab_size=512, seq_len=32, global_batch=8, seed=7)
        a = TokenStream(cfg).next()
        b = TokenStream(cfg).next()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_labels_are_shifted_tokens(self):
        cfg = DataConfig(vocab_size=512, seq_len=32, global_batch=4)
        batch = TokenStream(cfg).next()
        assert batch["tokens"].shape == (4, 32)
        assert batch["labels"].shape == (4, 32)
        np.testing.assert_array_equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])

    def test_host_sharding_partitions_batch(self):
        cfg = DataConfig(vocab_size=512, seq_len=16, global_batch=8)
        full = TokenStream(cfg).next()
        parts = [TokenStream(DataConfig(vocab_size=512, seq_len=16, global_batch=8, n_hosts=4,
                                        host_id=h)).next()["tokens"] for h in range(4)]
        np.testing.assert_array_equal(np.concatenate(parts, axis=0), full["tokens"])

    def test_state_resume_exact(self):
        cfg = DataConfig(vocab_size=512, seq_len=16, global_batch=4)
        s1 = TokenStream(cfg)
        for _ in range(5):
            s1.next()
        state = DataState.from_dict(s1.state.as_dict())
        expect = s1.next()
        got = TokenStream(cfg, state).next()
        np.testing.assert_array_equal(expect["tokens"], got["tokens"])

    def test_uneven_host_split_rejected(self):
        with pytest.raises(ValueError):
            TokenStream(DataConfig(vocab_size=512, seq_len=16, global_batch=6, n_hosts=4))
