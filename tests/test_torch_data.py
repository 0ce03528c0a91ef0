"""The port's synthetic LM pipeline against the reference's: the same
numpy draws, so the same tokens bit for bit (the port finds each token
by a search of the state's CDF where the reference compares the whole
vocabulary; the counts are the same), at two seeds and at qwen3-0.6b's
151,936-token vocabulary; and the reference's own pipeline properties."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro import data as jdata
from repro_torch import data as tdata


def test_exports_match_reference():
    assert tdata.__all__ == jdata.__all__


@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_batches_equal_reference(seed):
    want = jdata.make_lm_pipeline(vocab_size=100, batch=4, seq=32,
                                  seed=seed)
    got = tdata.make_lm_pipeline(vocab_size=100, batch=4, seq=32, seed=seed,
                                 device="cpu")
    for _ in range(3):
        a, b = next(want), next(got)
        assert b.tokens.dtype == torch.int32
        assert b.labels.dtype == torch.int32
        assert b.mask.dtype == torch.float32
        np.testing.assert_array_equal(b.tokens.numpy(), np.asarray(a.tokens))
        np.testing.assert_array_equal(b.labels.numpy(), np.asarray(a.labels))
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))


@pytest.mark.parametrize("vocab,seed", [(64, 0), (151936, 1)])
def test_dataset_draws_equal_reference(vocab, seed):
    want = jdata.SyntheticLMDataset(vocab, seed=seed)
    got = tdata.SyntheticLMDataset(vocab, seed=seed)
    rj, rt = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    for _ in range(2):
        a, b = want.sample(rj, 3, 24), got.sample(rt, 3, 24)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
    assert rj.random() == rt.random()


def test_dataset_learnable_structure():
    toks, labels = tdata.SyntheticLMDataset(64, seed=0).sample(
        np.random.default_rng(0), 8, 128)
    assert toks.shape == (8, 128) and labels.shape == (8, 128)
    assert toks.min() >= 0 and toks.max() < 64
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])


def test_pipeline_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.make_lm_pipeline(100, 2, 8)
