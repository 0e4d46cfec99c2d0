"""The port's synthetic data stream against the JAX package's:
determinism, resumability and structure (the reference's
``tests/test_data.py``, less the sharded batch, which belongs to
distribution), the successor table, and the Markov recurrence fed the
reference's own ``jax.random`` draws.

The port draws each step's first tokens, noise and follow mask from
numpy (seeded by (seed, step)), the reference from ``jax.random``, so
the two streams differ for one seed; the recurrence is checked exactly
on the reference's draws, the table exactly, and the follow rate of the
port's draws at ``structure=0.8`` within 0.8 ± 0.02 (over 32768 tokens of
a 32000-token vocabulary: 0.02 is ~9 standard deviations, and a chance
match of a noise token with the successor adds ~3e-5)."""

import jax
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro_torch.data import DataConfig, SyntheticLM, markov_tokens


def test_batch_is_pure_function_of_step():
    p1 = SyntheticLM(DataConfig(seed=3, vocab_size=100), batch=4, seq_len=32,
                     device="cpu")
    p2 = SyntheticLM(DataConfig(seed=3, vocab_size=100), batch=4, seq_len=32,
                     device="cpu")
    b1 = p1.batch_at(17)["tokens"]
    b2 = p2.batch_at(17)["tokens"]
    assert torch.equal(b1, b2)


def test_different_steps_and_seeds_differ():
    p = SyntheticLM(DataConfig(seed=3, vocab_size=100), batch=4, seq_len=32,
                    device="cpu")
    a = p.batch_at(0)["tokens"]
    assert (a != p.batch_at(1)["tokens"]).any()
    q = SyntheticLM(DataConfig(seed=4, vocab_size=100), batch=4, seq_len=32,
                    device="cpu")
    assert (a != q.batch_at(0)["tokens"]).any()


def test_tokens_in_vocab_range():
    p = SyntheticLM(DataConfig(seed=0, vocab_size=50), batch=8, seq_len=64,
                    device="cpu")
    t = p.batch_at(5)["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < 50
    assert t.shape == (8, 64) and t.dtype == torch.int64
    assert t.device == torch.device("cpu")


def test_markov_structure_is_learnable():
    """With structure=1.0 every next token is succ(prev): the bigram is
    deterministic, so an LM can reach ~0 loss — verify the property."""
    cfg = DataConfig(seed=1, vocab_size=64, structure=1.0)
    p = SyntheticLM(cfg, batch=2, seq_len=128, device="cpu")
    t = p.batch_at(0)["tokens"].numpy()
    follows = (t[:, 1:] == p._succ[t[:, :-1]]).mean()
    assert follows == 1.0


@pytest.mark.parametrize("seed,vocab", [(0, 32000), (5, 50280), (1, 64)])
def test_successor_table_equals_the_reference(seed, vocab):
    ours = SyntheticLM(DataConfig(seed=seed, vocab_size=vocab), 2, 8,
                       device="cpu")
    ref = JaxSyntheticLM(JaxDataConfig(seed=seed, vocab_size=vocab), 2, 8)
    assert ours._succ.dtype == np.int32
    np.testing.assert_array_equal(ours._succ, np.asarray(ref._succ))


@pytest.mark.parametrize("structure", [0.8, 0.0, 1.0])
@pytest.mark.parametrize("step", [0, 17])
def test_recurrence_on_the_reference_draws_gives_its_tokens(step,
                                                            structure):
    """The reference's ``_tokens`` draws, made here with its own keys, fed
    to the port's recurrence: the reference's tokens, exactly."""
    cfg = JaxDataConfig(seed=2, vocab_size=300, structure=structure)
    ref = JaxSyntheticLM(cfg, batch=3, seq_len=40)
    key = jax.random.fold_in(jax.random.key(cfg.seed), step)
    k_init, k_noise, k_mask = jax.random.split(key, 3)
    first = jax.random.randint(k_init, (3, 1), 0, cfg.vocab_size)
    noise = jax.random.randint(k_noise, (3, 40), 0, cfg.vocab_size)
    follow = jax.random.bernoulli(k_mask, cfg.structure, (3, 40))
    ours = SyntheticLM(DataConfig(seed=2, vocab_size=300,
                                  structure=structure), 3, 40, device="cpu")
    got = markov_tokens(ours._succ, np.asarray(first), np.asarray(noise),
                        np.asarray(follow))
    np.testing.assert_array_equal(got, np.asarray(ref.batch_at(step)
                                                  ["tokens"]))


def test_follow_rate_matches_the_structure():
    p = SyntheticLM(DataConfig(seed=0, vocab_size=32000, structure=0.8),
                    batch=8, seq_len=4097, device="cpu")
    t = p.batch_at(3)["tokens"].numpy()
    follows = (t[:, 1:] == p._succ[t[:, :-1]]).mean()
    assert abs(follows - 0.8) < 0.02


def test_the_stream_defaults_to_the_card():
    """Without ``device`` the tokens go to the card, and without a card
    that refuses, as every entry point of the port does."""
    cfg = DataConfig(seed=0, vocab_size=50)
    if torch.cuda.is_available():
        assert SyntheticLM(cfg, 2, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SyntheticLM(cfg, 2, 8)


def test_draws_are_a_pure_function_of_seed_and_step():
    p = SyntheticLM(DataConfig(seed=9, vocab_size=1000), 2, 16, device="cpu")
    for x, y in zip(p.draws(4, 2), p.draws(4, 2)):
        np.testing.assert_array_equal(x, y)
    first, noise, follow = p.draws(4, 2)
    assert first.shape == (2, 1) and noise.shape == follow.shape == (2, 16)
    assert follow.dtype == np.bool_
