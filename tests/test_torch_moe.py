"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the same parameters and inputs: one counterpart
for each test of tests/test_moe.py, and each case also held to the JAX
``moe_ffn`` on the same numpy inputs (outputs and aux values within
1e-5, float32).  The keep masks are held to the reference's own capacity
assignment (its top_k / one_hot / cumsum lines, in jnp) exactly; the
cases cover the train, prefill and decode capacities, token masks, and
deepseek-v2-lite's E 64 top-6 and arctic's E 128 top-2 at narrow widths,
where capacity drops choices."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.config import MoEConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import swiglu


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(mo: MoEConfig, D: int, seed: int = 0):
    """Reference params from ``init_moe`` and the port's copy of them."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D,
                       JMoEConfig(**dataclasses.asdict(mo)), jnp.float32)
    tp = _to_torch(jax.tree.map(np.asarray, jp))
    return jp, tp


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


_moe_ffn = jax.jit(jmoe.moe_ffn, static_argnames=("mo", "mode", "n_groups"))


@functools.partial(jax.jit, static_argnames=("mo", "mode", "n_groups"))
def _reference_keep(jp, x, mo, mode, n_groups=None, token_mask=None):
    """The reference's capacity assignment (``repro.models.moe.moe_ffn``'s
    routing lines, in jnp): the (G, N*k) keep mask."""
    B, S, D = x.shape
    N = B * S
    E, K = mo.n_experts, mo.top_k
    G = n_groups or 1
    if N % G:
        G = 1
    Ng = N // G
    C = jmoe._capacity(Ng, mo, mode)
    logits = jnp.einsum("gnd,de->gne", x.reshape(G, Ng, D), jp["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    onehot = jax.nn.one_hot(idx.reshape(G, Ng * K), E, dtype=jnp.int32)
    live = None
    if token_mask is not None:
        live = jnp.repeat(token_mask.reshape(G, Ng), K, axis=1)
        onehot = onehot * live[..., None]
    pos = (jnp.cumsum(onehot, axis=1) * onehot).sum(-1) - 1
    keep = pos < C
    if live is not None:
        keep = keep & live
    return keep


def _compare(jp, tp, x, mo, mode, n_groups=None, token_mask=None):
    """Outputs, aux values and keep masks of both packages; returns the
    port's (y, aux)."""
    jmo = JMoEConfig(**dataclasses.asdict(mo))
    jm = None if token_mask is None else jnp.asarray(token_mask)
    tm = None if token_mask is None else torch.as_tensor(token_mask)
    jy, jaux = _moe_ffn(jp, jnp.asarray(x), jmo, mode, n_groups=n_groups,
                        token_mask=jm)
    ty, taux = tmoe.moe_ffn(tp, torch.as_tensor(x), mo, mode,
                            n_groups=n_groups, token_mask=tm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **TOL)
    keep = tmoe.route(tp, torch.as_tensor(x), mo, mode, n_groups, tm)["keep"]
    np.testing.assert_array_equal(keep.numpy(), np.asarray(_reference_keep(
        jp, jnp.asarray(x), jmo, mode, n_groups, jm)))
    return ty, taux


def test_single_expert_equals_dense():
    """E=1 top-1 MoE with full capacity == its own expert SwiGLU."""
    mo = MoEConfig(n_experts=1, top_k=1, expert_ff=32, capacity_factor=1.0)
    jp, tp = _pair(mo, 16)
    x = _x((2, 8, 16))
    y, _ = _compare(jp, tp, x, mo, "decode")
    dense = {"wi": tp["wi_e"][0], "wg": tp["wg_e"][0], "wo": tp["wo_e"][0]}
    np.testing.assert_allclose(y.numpy(),
                               swiglu(dense, torch.as_tensor(x)).numpy(),
                               **TOL)


def test_decode_mode_is_dropless():
    mo = MoEConfig(n_experts=4, top_k=2, expert_ff=16, capacity_factor=0.1)
    jp, tp = _pair(mo, 8)
    _, aux = _compare(jp, tp, _x((16, 1, 8)), mo, "decode")
    assert float(aux["dropped_frac"]) == 0.0


def test_train_mode_drops_at_tight_capacity():
    mo = MoEConfig(n_experts=8, top_k=2, expert_ff=16, capacity_factor=0.25)
    jp, tp = _pair(mo, 8)
    y, aux = _compare(jp, tp, _x((4, 32, 8)), mo, "train")
    assert float(aux["dropped_frac"]) > 0.0
    assert np.isfinite(y.numpy()).all()
    assert np.isfinite(float(aux["load_balance"]))
    assert np.isfinite(float(aux["router_z"]))


def test_shared_and_residual_paths():
    mo = MoEConfig(n_experts=4, top_k=2, expert_ff=16, n_shared_experts=1,
                   dense_residual=True, dense_residual_ff=16)
    jp, tp = _pair(mo, 8)
    assert "shared" in tp and "residual" in tp
    x = _x((2, 4, 8))
    y, _ = _compare(jp, tp, x, mo, "decode")
    assert y.shape == x.shape
    # zeroing the routed experts leaves the shared + residual paths
    jp0 = dict(jp, wo_e=jnp.zeros_like(jp["wo_e"]))
    tp0 = dict(tp, wo_e=torch.zeros_like(tp["wo_e"]))
    y0, _ = _compare(jp0, tp0, x, mo, "decode")
    xf = torch.as_tensor(x).reshape(-1, 8)
    ref = swiglu(tp["shared"], xf) + swiglu(tp["residual"], xf)
    np.testing.assert_allclose(y0.reshape(-1, 8).numpy(), ref.numpy(), **TOL)


def test_gate_weights_normalized():
    mo = MoEConfig(n_experts=4, top_k=2, expert_ff=16)
    jp, tp = _pair(mo, 8)
    # identical experts => output independent of routing
    jsame = {k: jnp.broadcast_to(jp[k][:1], jp[k].shape)
             for k in ("wi_e", "wg_e", "wo_e")}
    jp2 = dict(jp, **jsame)
    tp2 = dict(tp, **{k: torch.as_tensor(np.array(v))
                      for k, v in jsame.items()})
    x = _x((2, 8, 8))
    y, _ = _compare(jp2, tp2, x, mo, "decode")
    dense = {"wi": tp2["wi_e"][0], "wg": tp2["wg_e"][0],
             "wo": tp2["wo_e"][0]}
    np.testing.assert_allclose(y.numpy(),
                               swiglu(dense, torch.as_tensor(x)).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_dead_tokens_do_not_consume_capacity():
    """Masked (finished / empty serving slot) tokens do not crowd live
    tokens out of expert capacity in dropping configs."""
    D = 8
    mo = MoEConfig(n_experts=2, top_k=1, expert_ff=16, capacity_factor=0.5)
    jp, tp = _pair(mo, D)
    # route every token to expert 0: capacity C = ceil(8*0.5/2) = 2
    router = np.zeros((D, 2), np.float32)
    router[:, 0] = 1.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.as_tensor(router))
    x = _x((8, 1, D))
    _, aux_all = _compare(jp, tp, x, mo, "train")
    assert float(aux_all["dropped_frac"]) > 0.0      # crowded without mask
    mask = np.zeros((8, 1), bool)
    mask[:2] = True                                   # 2 live, 6 dead
    y, aux = _compare(jp, tp, x, mo, "train", token_mask=mask)
    assert float(aux["dropped_frac"]) == 0.0         # live tokens all fit
    assert not y[2:].any()                           # dead rows are zero
    # live rows equal the dropless oracle (no mask, capacity = N)
    free = dataclasses.replace(mo, capacity_factor=float(mo.n_experts))
    y_free, _ = _compare(jp, tp, x, free, "train")
    np.testing.assert_allclose(y[:2].numpy(), y_free[:2].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_all_tokens_masked_is_finite():
    mo = MoEConfig(n_experts=2, top_k=1, expert_ff=16)
    jp, tp = _pair(mo, 8)
    y, aux = _compare(jp, tp, _x((4, 1, 8)), mo, "decode",
                      token_mask=np.zeros((4, 1), bool))
    assert np.isfinite(y.numpy()).all()
    assert float(aux["dropped_frac"]) == 0.0
    assert not y.any()


def test_grouped_dispatch_matches_ungrouped():
    """G > 1 grouped dispatch == G = 1 when capacity is unconstrained."""
    mo = MoEConfig(n_experts=4, top_k=2, expert_ff=16, capacity_factor=4.0)
    jp, tp = _pair(mo, 8)
    x = _x((4, 8, 8))
    y1, a1 = _compare(jp, tp, x, mo, "decode", n_groups=1)
    y2, a2 = _compare(jp, tp, x, mo, "decode", n_groups=4)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5, atol=1e-6)
    assert float(a1["dropped_frac"]) == float(a2["dropped_frac"]) == 0.0


# deepseek-v2-lite's routing (64 experts, top 6, 2 shared) and arctic's
# (128 experts, top 2, a dense residual) at narrow widths
FULL_ROUTING = {
    "deepseek-v2-lite": MoEConfig(n_experts=64, top_k=6, expert_ff=16,
                                  n_shared_experts=2, first_k_dense=1,
                                  first_dense_ff=32),
    "arctic": MoEConfig(n_experts=128, top_k=2, expert_ff=16,
                        dense_residual=True, dense_residual_ff=16),
}


@pytest.mark.parametrize("mode,shape,masked", [
    ("decode", (8, 1), False), ("decode", (8, 1), True),
    ("prefill", (1, 48), False), ("train", (2, 24), False),
    ("chunk", (1, 32), True)])
@pytest.mark.parametrize("arch", sorted(FULL_ROUTING))
def test_full_expert_counts_drop_like_the_reference(arch, mode, shape,
                                                    masked):
    """At the full configs' expert counts and top-k the capacity binds
    (decode: C = ceil(k * 8 * 4 / E), 3 for deepseek-v2-lite and 1 for
    arctic on 8 slots): the same choices drop in both packages, with and
    without a token mask (dead slots in decode, a chunk's padding)."""
    mo = FULL_ROUTING[arch]
    D = 16
    jp, tp = _pair(mo, D, seed=3)
    # tokens near one direction crowd the same experts
    x = (_x((D,), seed=5) + 0.3 * _x(shape + (D,), seed=4)).astype(
        np.float32)
    mask = None
    if masked:
        mask = np.ones(shape, bool)
        mask.reshape(-1)[::3] = False
    _, aux = _compare(jp, tp, x, mo, mode, token_mask=mask)
    if mode == "decode":
        assert tmoe._capacity(8, mo, "decode") == {"deepseek-v2-lite": 3,
                                                   "arctic": 1}[arch]
    if mode in ("decode", "train") and not masked:
        assert float(aux["dropped_frac"]) > 0.0
