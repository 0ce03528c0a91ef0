"""The port's recurrent blocks (``repro_torch.models.recurrent``) against
the reference's (``repro.models.recurrent``) on the same numpy inputs
from a seed, and the reference's own invariants held port-side at its
own bars (``tests/test_recurrent.py``): the RG-LRU scan against its
stepwise form and against a continuation from ``h0``, the mLSTM parallel
form against its steps, the sLSTM continued from a state, and the
RG-LRU's stability over 2048 steps.

Tolerance against the reference: 1e-5 (absolute and relative; products
and sums of another library, in the same order for the scan).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.models import recurrent as jr
from repro_torch.models import recurrent as tr

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """These ops are small: one intra-op thread runs them about as fast
    alone, and far faster beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, *shapes, shift=0.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) + shift).astype(np.float32) for s in shapes]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("s", [1, 2, 7, 24, 33, 128])
def test_associative_scan_matches_a_loop(s):
    """The odd/even recursion at even, odd and power-of-two lengths
    against the sequential scan it computes."""
    a, b = _t(*_arrays(s, (2, s, 3), (2, s, 3)))
    a = torch.sigmoid(a)
    got_a, got_b = tr.associative_scan(tr._lru_combine, (a, b), dim=1)
    acc_a, acc_b = a[:, 0], b[:, 0]
    for t in range(s):
        if t:
            acc_a, acc_b = tr._lru_combine((acc_a, acc_b),
                                           (a[:, t], b[:, t]))
        torch.testing.assert_close(got_a[:, t], acc_a, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(got_b[:, t], acc_b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("s", [1, 24, 97])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches_reference(s, with_h0):
    b, d = 2, 8
    x, gx, ga, lam, h0 = _arrays(10 + s, (b, s, d), (b, s, d), (b, s, d),
                                 (d,), (b, d))
    h0 = h0 if with_h0 else None
    jy, jh = jr.rg_lru(*_j(x, gx, ga, lam), h0=None if h0 is None
                       else jnp.asarray(h0))
    ty, th = tr.rg_lru(*_t(x, gx, ga, lam), h0=None if h0 is None
                       else torch.from_numpy(h0))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


def test_rg_lru_bf16_input_matches_reference():
    """A bf16 branch input: the gates in fp32, y rounded to bf16."""
    b, s, d = 2, 16, 8
    x, gx, ga, lam = _arrays(3, (b, s, d), (b, s, d), (b, s, d), (d,))
    jy, jh = jr.rg_lru(jnp.asarray(x, jnp.bfloat16), *_j(gx, ga, lam))
    ty, th = tr.rg_lru(torch.from_numpy(x).bfloat16(), *_t(gx, ga, lam))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    _close(th, jh)


def test_rg_lru_step_matches_reference():
    b, d = 3, 8
    x, gx, ga, lam, h = _arrays(4, (b, d), (b, d), (b, d), (d,), (b, d))
    jy, jh = jr.rg_lru_step(*_j(x, gx, ga, lam, h))
    ty, th = tr.rg_lru_step(*_t(x, gx, ga, lam, h))
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("s", [1, 12, 40])
def test_mlstm_parallel_matches_reference(s):
    b, h, d = 2, 2, 4
    q, k, v, i_pre, f_pre = _arrays(20 + s, (b, h, s, d), (b, h, s, d),
                                    (b, h, s, d), (b, h, s), (b, h, s))
    f_pre = f_pre + 2.0
    want = jr.mlstm_parallel(*_j(q, k, v, i_pre, f_pre))
    got = tr.mlstm_parallel(*_t(q, k, v, i_pre, f_pre))
    _close(got, want)


def test_mlstm_step_matches_reference():
    """Twelve steps from the zero state (m = 0, as the cache starts),
    every output and state held."""
    b, h, s, d = 2, 2, 12, 4
    q, k, v, i_pre, f_pre = _arrays(5, (b, h, s, d), (b, h, s, d),
                                    (b, h, s, d), (b, h, s), (b, h, s))
    jst = {"C": jnp.zeros((b, h, d, d)), "n": jnp.zeros((b, h, d)),
           "m": jnp.zeros((b, h))}
    tst = {key: torch.zeros(tuple(val.shape)) for key, val in jst.items()}
    for t in range(s):
        args = (q[:, :, t], k[:, :, t], v[:, :, t], i_pre[:, :, t],
                f_pre[:, :, t])
        jo, jst = jr.mlstm_step(*_j(*args), jst)
        to, tst = tr.mlstm_step(*_t(*args), tst)
        _close(to, jo)
        for key in jst:
            _close(tst[key], jst[key])


@pytest.mark.parametrize("split", [None, 5])
def test_slstm_scan_matches_reference(split):
    """From the zero state, and continued from the state after 5 steps."""
    b, s, h, d = 2, 10, 2, 4
    (wx,) = _arrays(6, (b, s, h, 4, d))
    r = dict(zip("zifo", (0.1 * a for a in _arrays(7, *[(h, d, d)] * 4))))
    jr_w = {g: jnp.asarray(a) for g, a in r.items()}
    tr_w = {g: torch.from_numpy(a) for g, a in r.items()}
    if split is None:
        jy, jst = jr.slstm_scan(jnp.asarray(wx), jr_w)
        ty, tst = tr.slstm_scan(torch.from_numpy(wx), tr_w)
    else:
        _, jst0 = jr.slstm_scan(jnp.asarray(wx[:, :split]), jr_w)
        _, tst0 = tr.slstm_scan(torch.from_numpy(wx[:, :split]), tr_w)
        for key in jst0:
            _close(tst0[key], jst0[key])
        jy, jst = jr.slstm_scan(jnp.asarray(wx[:, split:]), jr_w, jst0)
        ty, tst = tr.slstm_scan(torch.from_numpy(wx[:, split:]), tr_w, tst0)
    _close(ty, jy)
    assert sorted(tst) == sorted(jst)
    for key in jst:
        _close(tst[key], jst[key])


# ---------------------------------------------------------------------------
# The reference's invariants, port-side (tests/test_recurrent.py's bars)
# ---------------------------------------------------------------------------

def test_rg_lru_scan_matches_stepwise():
    b, s, d = 2, 24, 8
    x, gx, ga, lam = _t(*_arrays(0, (b, s, d), (b, s, d), (b, s, d), (d,)))
    y, h_last = tr.rg_lru(x, gx, ga, lam)
    h = torch.zeros((b, d))
    outs = []
    for t in range(s):
        o, h = tr.rg_lru_step(x[:, t], gx[:, t], ga[:, t], lam, h)
        outs.append(o)
    torch.testing.assert_close(y, torch.stack(outs, dim=1), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(h_last, h, atol=1e-5, rtol=1e-5)


def test_rg_lru_state_continuation():
    b, s, d = 1, 16, 4
    args = _t(*_arrays(1, (b, s, d), (b, s, d), (b, s, d)))
    (lam,) = _t(*_arrays(11, (d,)))
    y_full, _ = tr.rg_lru(*args, lam)
    y1, h1 = tr.rg_lru(*[a[:, :8] for a in args], lam)
    y2, _ = tr.rg_lru(*[a[:, 8:] for a in args], lam, h0=h1)
    torch.testing.assert_close(y_full, torch.cat([y1, y2], dim=1),
                               atol=1e-5, rtol=1e-5)


def test_mlstm_parallel_matches_stepwise():
    b, h, s, d = 1, 2, 12, 4
    q, k, v, i_pre, f_pre = _t(*_arrays(2, (b, h, s, d), (b, h, s, d),
                                        (b, h, s, d), (b, h, s), (b, h, s)))
    f_pre = f_pre + 2.0
    y_par = tr.mlstm_parallel(q, k, v, i_pre, f_pre)
    state = {"C": torch.zeros((b, h, d, d)), "n": torch.zeros((b, h, d)),
             "m": torch.zeros((b, h))}
    outs = []
    for t in range(s):
        o, state = tr.mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                 i_pre[:, :, t], f_pre[:, :, t], state)
        outs.append(o)
    torch.testing.assert_close(y_par, torch.stack(outs, dim=2), atol=1e-3,
                               rtol=1e-2)


def test_slstm_state_continuation():
    b, s, h, d = 2, 10, 2, 4
    (wx,) = _t(*_arrays(3, (b, s, h, 4, d)))
    r = {g: 0.1 * a for g, a in zip("zifo", _t(*_arrays(
        13, *[(h, d, d)] * 4)))}
    y_full, _ = tr.slstm_scan(wx, r)
    y1, st1 = tr.slstm_scan(wx[:, :5], r)
    y2, _ = tr.slstm_scan(wx[:, 5:], r, state=st1)
    torch.testing.assert_close(y_full, torch.cat([y1, y2], dim=1),
                               atol=1e-5, rtol=1e-5)


def test_rg_lru_stability():
    """Decay a in (0, 1): the state stays bounded over 2048 steps."""
    b, s, d = 1, 2048, 4
    (x,) = _t(*_arrays(4, (b, s, d)))
    y, h = tr.rg_lru(x, x, x, torch.ones((d,)))
    assert bool(torch.isfinite(y).all())
    assert float(h.abs().max()) < 100.0
