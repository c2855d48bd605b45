"""The port's synthetic token pipeline (``repro_torch.data.tokens``)
against the JAX package's ``data/tokens.py``: the same Zipf law, the same
order-1 Markov mixing and label shift on the same ``base`` ids, and
batches that are a pure function of (seed, step)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as jtok
from repro_torch.data import tokens
from repro_torch.data.tokens import DataConfig, batch_at


def test_zipf_logits_match_jax():
    np.testing.assert_allclose(tokens._zipf_logits(1000, 1.1).numpy(),
                               np.asarray(jtok._zipf_logits(1000, 1.1)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("vocab,jump", [(256, 7), (32064, 7), (131072, 3)])
def test_markov_transform_matches_the_references_arithmetic(vocab, jump):
    """The reference's lines on the same base ids, in its int32."""
    base = np.random.default_rng(vocab).integers(0, vocab, (3, 17))
    b = jnp.asarray(base, jnp.int32)
    rolled = (b[:, :-1] * jump + b[:, 1:]) % vocab
    got_t, got_l = tokens.markov_tokens(torch.from_numpy(base), vocab, jump)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(rolled[:, :-1]))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(rolled[:, 1:]))


def test_batch_shapes_match_the_reference():
    cfg = DataConfig(vocab=256, seq_len=16, global_batch=4, seed=3)
    jcfg = jtok.DataConfig(vocab=256, seq_len=16, global_batch=4, seed=3)
    for frontend, d in (("none", 0), ("audio", 32)):
        got = batch_at(cfg, 5, frontend=frontend, d_model=d, device="cpu")
        want = jtok.batch_at(jcfg, 5, frontend=frontend, d_model=d)
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
        if frontend != "none":
            assert got["embeds"].dtype == torch.float32
            assert 0.01 < float(got["embeds"].std()) < 0.03


def test_batches_are_a_function_of_seed_and_step():
    cfg = DataConfig(vocab=512, seq_len=33, global_batch=8, seed=1)
    a = batch_at(cfg, 7, device="cpu")
    b = batch_at(cfg, 7, device="cpu")
    c = batch_at(cfg, 8, device="cpu")
    d = batch_at(DataConfig(vocab=512, seq_len=33, global_batch=8, seed=2), 7,
                 device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    # labels are the tokens shifted by one
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512


def test_base_ids_follow_the_zipf_law():
    cfg = DataConfig(vocab=64, seq_len=2000, global_batch=8, seed=0)
    g = torch.Generator().manual_seed(tokens.step_seed(0, 0))
    probs = torch.softmax(tokens._zipf_logits(64, 1.1), 0)
    base = torch.multinomial(probs, 8 * 2001, replacement=True, generator=g)
    freq = torch.bincount(base, minlength=64).float() / base.numel()
    assert float((freq - probs).abs().max()) < 0.01
    assert cfg.markov_jump == 7 and cfg.zipf_alpha == 1.1


def test_batch_at_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_at(DataConfig(vocab=8, seq_len=4, global_batch=1), 0)
