"""The port's speculative verifier against the JAX package's.

Greedy rows must give the JAX function's tokens exactly; sampled rows must
emit tokens whose marginals equal plain autoregressive sampling (the two
frameworks draw different random numbers, so distributions are compared,
with the JAX package's own bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from karanta_tpu.inference.sampling import (
    spec_verify_sampled as j_spec_verify_sampled,
)
from karanta_tpu_torch.inference.sampling import spec_verify_sampled


def _setup():
    rng = np.random.default_rng(7)
    v, gamma = 8, 3
    logits = rng.normal(size=(1, gamma + 1, v)).astype(np.float32)
    draft = rng.integers(0, v, size=(1, gamma)).astype(np.int64)
    return logits, draft, v, gamma


def test_greedy_rows_equal_the_jax_verifier():
    """Rows at temperature 0 (with drafts that match the argmax for 0..3
    positions) give the JAX verifier's y and n_new, whatever the generator;
    a sampled row beside them does not change them."""
    rng = np.random.default_rng(3)
    b, gamma, v = 6, 3, 50
    logits = rng.normal(size=(b, gamma + 1, v)).astype(np.float32)
    greedy = logits.argmax(-1)
    draft = rng.integers(0, v, size=(b, gamma))
    for row, n_ok in enumerate([0, 1, 2, 3, 3, 1]):
        draft[row, :n_ok] = greedy[row, :n_ok]
    temps = np.zeros((b,), np.float32)
    temps[-1] = 0.8
    y_j, n_j = j_spec_verify_sampled(jnp.asarray(logits),
                                     jnp.asarray(draft, jnp.int32),
                                     jnp.asarray(temps), jax.random.PRNGKey(0))
    y_j, n_j = np.asarray(y_j), np.asarray(n_j)
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        y, n_new = spec_verify_sampled(torch.from_numpy(logits),
                                       torch.from_numpy(draft),
                                       torch.from_numpy(temps), gen)
        y, n_new = y.numpy(), n_new.numpy()
        np.testing.assert_array_equal(n_new[:-1], n_j[:-1])
        np.testing.assert_array_equal(n_new[:-1], [1, 2, 3, 4, 4, 2][:-1])
        for row in range(b - 1):
            np.testing.assert_array_equal(y[row, :n_new[row]],
                                          y_j[row, :n_j[row]])


def test_sampled_marginals_match_the_target():
    """20,000 verify passes at temperature 1: the first emitted token is
    distributed as p_0, the second (given the first draft accepted) as p_1,
    and the acceptance lengths follow the accept rule."""
    logits, draft, v, gamma = _setup()
    n = 20_000
    gen = torch.Generator().manual_seed(0)
    y, n_new = spec_verify_sampled(
        torch.from_numpy(np.repeat(logits, n, axis=0)),
        torch.from_numpy(np.repeat(draft, n, axis=0)), torch.ones(n), gen)
    y, n_new = y.numpy(), n_new.numpy()
    probs = torch.softmax(torch.from_numpy(logits[0]), dim=-1).numpy()

    emp0 = np.bincount(y[:, 0], minlength=v) / n
    np.testing.assert_allclose(emp0, probs[0], atol=0.02)
    cond = n_new > 1
    emp1 = np.bincount(y[cond, 1], minlength=v) / cond.sum()
    np.testing.assert_allclose(emp1, probs[1], atol=0.03)

    p_acc = np.array([probs[i, int(draft[0, i])] for i in range(gamma)])
    expect = []
    for k in range(1, gamma + 2):
        e = np.prod(p_acc[:k - 1])
        if k <= gamma:
            e *= 1.0 - p_acc[k - 1]
        expect.append(e)
    emp_len = np.bincount(n_new, minlength=gamma + 2)[1:] / n
    np.testing.assert_allclose(emp_len, expect, atol=0.02)
