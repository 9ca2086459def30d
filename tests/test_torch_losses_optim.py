"""The port's losses, optimizers and schedule against the reference's
(``tests/test_losses_optim.py``'s cases, each also held to the JAX
function on the same arrays).  Optimizers are compared on identical
numpy gradients: Adam's first update is about sign(g), so a gradient
difference near zero would move a parameter by +-lr either way."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_model
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import learning_rate as jax_lr
from repro.train.losses import cross_entropy as jax_ce
from repro_torch import bridge, optim
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.models.blocks import step_layout
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedule import learning_rate
from repro_torch.train.losses import IGNORE, cross_entropy
from repro_torch.tree import leaves

# optimizer results on the same float32 arrays: float32 rounding apart


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPT_TOL = dict(rtol=1e-6, atol=1e-6)
# a bfloat16 leaf (Adafactor's first moment) within one bf16 ulp of its
# largest element per step taken: a float32 difference at a rounding
# boundary flips an element's last bit, and the flip carries (times
# beta1) into the next steps' moment, whatever that element's new size
BF16_ULP = 2.0 ** -7
N_STEPS = 3


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("z_weight", [0.0, 1e-2])
def test_cross_entropy_matches_manual_and_reference(z_weight):
    logits = np.random.default_rng(0).normal(size=(2, 4, 8)).astype(
        np.float32)
    labels = np.asarray([[1, 2, 3, IGNORE], [0, IGNORE, 5, 7]], np.int32)
    loss, m = cross_entropy(_t(logits), _t(labels), z_weight)
    lp = torch.log_softmax(_t(logits).double(), dim=-1).numpy()
    vals = [-lp[b, t, labels[b, t]] for b in range(2) for t in range(4)
            if labels[b, t] != IGNORE]
    assert float(m["tokens"]) == len(vals)
    if not z_weight:
        assert np.isclose(float(loss), np.mean(vals), rtol=1e-5)
    jloss, jm = jax_ce(jnp.asarray(logits), jnp.asarray(labels), z_weight)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)


def test_adamw_first_step_matches_reference():
    tc = TrainConfig(learning_rate=0.1, weight_decay=0.0, grad_clip=1e9,
                     beta1=0.9, beta2=0.999)
    p = {"wq": torch.tensor([1.0, -2.0])}
    g = {"wq": torch.tensor([0.5, 0.5])}
    p2, st2, _ = adamw.apply_updates(p, g, adamw.init_state(p, tc), tc, 0.1)
    # bias-corrected first step: update = g/(|g|+eps) = sign(g)
    np.testing.assert_allclose(p2["wq"].numpy(), [1.0 - 0.1, -2.0 - 0.1],
                               rtol=1e-4)
    assert int(st2["step"]) == 1


def test_adamw_weight_decay_mask():
    tc = TrainConfig(learning_rate=0.1, weight_decay=0.5, grad_clip=1e9)
    p = {"wq": torch.tensor([1.0]), "ln1": torch.tensor([1.0])}
    g = {"wq": torch.tensor([0.0]), "ln1": torch.tensor([0.0])}
    p2, _, _ = adamw.apply_updates(p, g, adamw.init_state(p, tc), tc, 0.1)
    assert float(p2["wq"][0]) < 1.0           # decayed
    assert float(p2["ln1"][0]) == 1.0          # norm gain exempt


def test_adafactor_factored_state_shapes():
    tc = TrainConfig(optimizer="adafactor")
    p = {"w": torch.zeros((8, 16)), "b": torch.zeros((8,))}
    st = adafactor.init_state(p, tc)
    assert st["slots"]["w"]["vr"].shape == (8,)
    assert st["slots"]["w"]["vc"].shape == (16,)
    assert "v" in st["slots"]["b"]


def test_grad_clip():
    g = {"w": torch.tensor([3.0, 4.0])}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert np.isclose(float(norm), 5.0)
    assert np.isclose(float(torch.linalg.norm(clipped["w"])), 1.0)
    jc, jn = jax_adamw.clip_by_global_norm({"w": jnp.asarray([3.0, 4.0])},
                                           1.0)
    np.testing.assert_allclose(clipped["w"].numpy(), np.asarray(jc["w"]),
                               rtol=1e-7)
    assert float(norm) == float(jn)


def test_schedule_warmup_and_decay():
    tc = TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100)
    jtc = JaxTrainConfig(learning_rate=1.0, warmup_steps=10,
                         total_steps=100)
    steps = (0, 5, 10, 50, 100, 150)
    lrs = [learning_rate(tc, s) for s in steps]
    assert lrs[0] < lrs[1] < lrs[2]            # warmup
    assert lrs[2] >= lrs[3] >= lrs[4]          # decay
    assert lrs[4] >= 0.099                     # floor at 10%
    assert lrs == [float(jax_lr(jtc, jnp.int32(s))) for s in steps]


def _stack_trees(arch, seed, n):
    """Reduced params of ``arch`` from the reference's init, and ``n``
    gradient trees of the same layout drawn with numpy: (reference
    params, [reference grads], port params, [port grads])."""
    cfg = jax_config(arch).reduced()
    jp = jax.tree.map(np.asarray, jax_model(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    jgs = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype)
                        * 1e-2, jp) for _ in range(n)]
    return (jp, jgs, bridge.params_from_jax(jp),
            [bridge.params_from_jax(g) for g in jgs])


def _close_trees(port, ref, **tol):
    ref = dict(leaves(ref))
    assert set(dict(leaves(port))) == set(ref)
    for path, a in leaves(port):
        b = ref[path].float().numpy()
        t = dict(tol)
        if a.dtype == torch.bfloat16 and t.get("rtol"):
            t = dict(rtol=0, atol=N_STEPS * BF16_ULP * np.abs(b).max())
        np.testing.assert_allclose(a.float().numpy(), b,
                                   err_msg=str(path), **t)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-2.7b",
                                  "deepseek-v2-lite-16b"])
def test_optimizer_steps_match_reference(arch, opt):
    """Three updates on identical gradients from the same state: params
    and state equal the reference's to float32 rounding.  Adafactor runs
    on the stacked-layer layout (a norm gain (L, d) factored, the update
    clip over all layers of a leaf), so its state shapes are the
    reference's."""
    kw = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=1.0,
              optimizer=opt)
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    jp, jgs, tp, tgs = _stack_trees(arch, seed=1, n=N_STEPS)
    jmod = jax_adafactor if opt == "adafactor" else jax_adamw
    layout = step_layout(torch_config(arch).reduced())
    jst, st = jmod.init_state(jp, jtc), optim.init_state(tp, tc, layout)
    _close_trees(st, bridge.opt_state_from_jax(
        jax.tree.map(np.asarray, jst)), rtol=0, atol=0)
    japply = jax.jit(jmod.apply_updates, static_argnums=3)
    for jg, tg in zip(jgs, tgs):
        lr = learning_rate(tc, st["step"])
        jp, jst, jm = japply(jp, jg, jst, jtc, jnp.float32(lr))
        tp, st, tm = optim.apply_updates(tp, tg, st, tc, lr, layout)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    _close_trees(tp, bridge.params_from_jax(jax.tree.map(np.asarray, jp)),
                 **OPT_TOL)
    _close_trees(st, bridge.opt_state_from_jax(
        jax.tree.map(np.asarray, jst)), **OPT_TOL)
    if opt == "adafactor":
        # deepseek-v2-lite's dense first layer keeps its own slots
        n_prefix = len(st["slots"].get("prefix", []))
        assert n_prefix == (1 if arch == "deepseek-v2-lite-16b" else 0)
        L, d = len(tp["layers"]) - n_prefix, tp["final_norm"].shape[0]
        assert st["slots"]["layers"][0]["ln1"]["vr"].shape == (L,)
        assert st["slots"]["layers"][0]["ln1"]["vc"].shape == (d,)
