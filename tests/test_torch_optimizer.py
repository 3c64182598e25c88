"""The port's optimizers, schedules and Newton-Schulz against the JAX
package's (optax) on the CPU.

The same parameter tree (the tiny model's, from the JAX init) and the same
gradients from numpy seeds go through both chains. float32 parameters agree
within 1e-6 after every step; bfloat16 parameters within one bf16 step
(XLA may keep an intermediate in float32 where eager PyTorch rounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu.ops import newton_schulz as jns
from karanta_tpu.training import optimizer as jopt
from karanta_tpu_torch.ops import newton_schulz as tns
from karanta_tpu_torch.training import optimizer as topt
from karanta_tpu_torch.utils.tree import flatten_tree, unflatten_tree

JCFG = j_tiny_config()
# four decoder layers: see test_orthogonalize_matches_jax
JCFG = dataclasses.replace(JCFG, text=dataclasses.replace(JCFG.text,
                                                          num_layers=4))


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,total", [(0, 5), (3, 10), (4, 4)])
def test_schedules_match_optax(kind, warmup, total):
    j = jopt.make_lr_schedule(kind, 2e-4, warmup, total)
    t = topt.make_lr_schedule(kind, 2e-4, warmup, total)
    for step in range(total + 2):
        np.testing.assert_allclose(float(t(step)), float(j(step)),
                                   rtol=1e-6, atol=0, err_msg=str(step))


@pytest.mark.parametrize("shape", [(40, 16), (16, 40), (3, 8, 24),
                                   (4, 64), (2, 24, 24)])
def test_orthogonalize_matches_jax(shape):
    """Bit-equal at these shapes, float32 and bf16 inputs. The iteration
    rounds every product to bf16, so where XLA's CPU product sums in another
    order than PyTorch's, a float32 rounding difference flips a bf16
    rounding and five iterations spread it (next test). XLA itself rounds a
    matrix of fewer than 4 rows differently from its batched product of the
    same matrix, which the port matches (the test after)."""
    g = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jns.orthogonalize(jnp.asarray(g, jdt))
                          .astype(jnp.float32))
        got = tns.orthogonalize(torch.from_numpy(g).to(dt)).float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(4, 64, 96), (3, 16), (36, 2048),
                                   (256, 256)])
def test_orthogonalize_within_bf16_flips(shape):
    """Shapes whose products XLA sums in another order: within 5% normwise
    (0.07-3.4% measured on these inputs)."""
    g = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = np.asarray(jns.orthogonalize(jnp.asarray(g)))
    got = tns.orthogonalize(torch.from_numpy(g)).numpy()
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 5e-2, err


def test_orthogonalize_small_rows_match_jax_batched():
    g = np.random.default_rng(1).normal(size=(3, 16)).astype(np.float32)
    batched = np.asarray(jns.orthogonalize(jnp.asarray(g[None])))[0]
    got = tns.orthogonalize(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, batched)


def test_muon_update_matches_jax():
    rng = np.random.default_rng(2)
    g = rng.normal(size=(2, 32, 8)).astype(np.float32)
    m = rng.normal(size=(2, 32, 8)).astype(np.float32)
    ju, jm = jns.muon_update(jnp.asarray(g), jnp.asarray(m))
    tu, tm = tns.muon_update(torch.from_numpy(g), torch.from_numpy(m))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = np.asarray(ju)
    assert np.linalg.norm(tu.numpy() - want) / np.linalg.norm(want) < 3e-2


def _check_updates(tu, ju, bf16: bool, muon: bool):
    """Adam leaves: within 1e-6 (float32) or one bf16 step. Muon leaves:
    within 5% normwise with float32 parameters, 15% with bf16 ones (up to
    1.3% and 10.8% measured, the largest on the 4-row stacked (L, n)
    biases: bf16 rounding flips spread by the Newton-Schulz iteration, see
    test_orthogonalize_within_bf16_flips, with the bf16 momentum rounding on
    top)."""
    got = flatten_tree(tu)
    for path, want in _flat(ju).items():
        have = got[path].float().numpy()
        want = np.asarray(want, np.float32)
        if muon and topt.default_label_fn(path, got[path]) == "muon":
            err = np.linalg.norm(have - want)
            assert err <= (0.15 if bf16 else 5e-2) * np.linalg.norm(want), \
                path
        elif bf16:
            # one bf16 step at each value: 2^(exponent - 7)
            step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                       1e-30))) - 7)
            assert np.all(np.abs(have - want) <= step), path
        else:
            np.testing.assert_allclose(have, want, atol=1e-6, rtol=0,
                                       err_msg=path)


@pytest.mark.parametrize("name", ["adamw", "muon"])
@pytest.mark.parametrize("bf16", [False, True])
def test_optimizer_on_the_model_tree_matches_optax(name, bf16):
    """Five steps with the cosine schedule (warmup 2), weight decay, clipping
    at 1.0 that triggers on step 2 only, and a NaN gradient on step 4 that
    the skip leaves out: each step's updates against optax's, from the same
    gradients. ``step`` (in place) gives ``update`` + apply_updates to the
    bit."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    jp = j_init_params(JCFG, jax.random.PRNGKey(0), jdt)

    def port_params():
        return unflatten_tree({k: torch.from_numpy(np.array(v, np.float32))
                               .to(tdt) for k, v in _flat(jp).items()})

    tp, sp = port_params(), port_params()
    sched = ("cosine", 1e-2, 2, 6)
    jo = jopt.make_optimizer(name, jopt.make_lr_schedule(*sched),
                             weight_decay=0.1, max_grad_norm=1.0)
    to = topt.make_optimizer(name, topt.make_lr_schedule(*sched),
                             weight_decay=0.1, max_grad_norm=1.0)
    jstate, tstate, sstate = jo.init(jp), to.init(tp), to.init(sp)
    rng = np.random.default_rng(4)
    update = jax.jit(jo.update)
    for step in range(5):
        scale = 0.5 if step == 1 else 0.002
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in _flat(jp).items()}
        if step == 3:
            grads["text/final_norm"][0] = np.nan
        jg = jax.tree.map(lambda p, g: jnp.asarray(g, p.dtype), jp,
                          unflatten_tree(grads))
        ju, jstate = update(jg, jstate, jp)
        jp = jax.tree.map(lambda p, u: (p + u).astype(p.dtype), jp, ju)
        tg = {k: torch.from_numpy(g).to(tdt) for k, g in grads.items()}
        np.testing.assert_allclose(float(topt.global_norm(tg)),
                                   float(optax.global_norm(jg)),
                                   rtol=1e-2 if bf16 else 1e-6)
        tu, tstate = to.update(tg, tstate, tp)
        _check_updates(tu, ju, bf16, name == "muon")
        tp = topt.apply_updates(tp, tu)
        sp, sstate = to.step(dict(tg), sstate, sp)
        for path, leaf in flatten_tree(tp).items():
            assert torch.equal(flatten_tree(sp)[path], leaf), path
    assert int(tstate["count"]) == int(sstate["count"]) == 4
    assert int(tstate["notfinite_count"]) == 0


def test_update_api_and_give_up_after_ten_nonfinite_steps():
    """``update`` returns optax-style updates (zeros while skipping); the
    11th nonfinite step in a row applies, as optax's escape hatch does."""
    p = {"w": jnp.ones((4, 4), jnp.float32)}
    jo = jopt.make_optimizer("adamw", 1e-2)
    to = topt.make_optimizer("adamw", 1e-2)
    jstate, tstate = jo.init(p), to.init({"w": torch.ones(4, 4)})
    g = np.full((4, 4), np.nan, np.float32)
    for i in range(11):
        ju, jstate = jo.update({"w": jnp.asarray(g)}, jstate, p)
        tu, tstate = to.update({"w": torch.from_numpy(g)}, tstate,
                               {"w": torch.ones(4, 4)})
        assert np.isnan(np.asarray(ju["w"])).any() == \
            bool(torch.isnan(tu["w"]).any()), i
        if i < 10:
            assert float(tu["w"].abs().max()) == 0.0
    assert int(tstate["notfinite_count"]) == \
        int(jstate.notfinite_count) == 11
    assert int(tstate["count"]) == 1
