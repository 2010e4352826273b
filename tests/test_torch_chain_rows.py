"""The backward chains' row passes and reduces (K6, K8, K9) as the CPU can
check them.

- The partition the wrappers use to size the row passes' partial sums
  (``row_partition``) covers every row exactly once, for a range of row
  counts and SM counts.
- A numpy model of the fixed-order reduces (``reduce_split``: one level, or
  chunks of partial rows in order, then the chunks in order, each sum in
  fp32 and rounded once) matches an fp64 sum.
- K6's twin against ``jax.vjp`` of the JAX ``fused_preattn_vjp`` (its Pallas
  backward in interpret mode, as the JAX suite runs it on the CPU) at the
  model's width (D 768, 3D 2304) and a ragged 1370 rows; K8's and K9's twins
  against theirs at a ragged row count, D 128 and F 256. Tolerances are the
  JAX suite's: 2e-4 on gradients (5e-4 for the MPNet chain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.ops import fused_layer as jfl
from radzero_torch.ops import fused_layer as tfl

ROWS = [1, 2, 7, 100, 131, 263, 264, 265, 527, 528, 529, 1370, 2740, 16384, 87680]


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
@pytest.mark.parametrize("per_sm", [tfl._LN_BWD_BLOCKS_PER_SM, tfl._COLSUM_BLOCKS_PER_SM])
def test_row_partition_covers_every_row_once(sms, per_sm):
    blocks = per_sm * sms
    for m in ROWS:
        chunk, parts = tfl.row_partition(m, blocks)
        assert 1 <= parts <= blocks and chunk >= 1
        owned = np.zeros(m, dtype=np.int64)
        for b in range(parts):  # the blocks the kernel launches: ceil(m / chunk)
            lo, hi = b * chunk, min(m, (b + 1) * chunk)
            assert lo < hi, (m, b)  # every launched block holds rows
            owned[lo:hi] += 1
        assert (owned == 1).all(), m
        assert parts == -(-m // chunk)


def _reduce_model(part, per):
    """The kernels' order: fp32 sums over s in order (one level), or over
    chunks of ``per`` rows in order and then over the chunks in order."""
    part = part.astype(np.float32)
    if per is None:
        chunks = [part]
    else:
        chunks = [part[i:i + per] for i in range(0, part.shape[0], per)]
    level = []
    for c in chunks:
        acc = np.zeros(part.shape[1], dtype=np.float32)
        for row in c:
            acc = acc + row  # fp32 + fp32 -> fp32, one row at a time
        level.append(acc)
    out = np.zeros(part.shape[1], dtype=np.float32)
    for row in level:
        out = out + row
    return out


# (partial rows, columns): K6's LayerNorm sums and db at 64 images, K8's dgelu
# column partials (685 row tiles of 3072), K9's at 16 384 rows, the old 32-row
# partials, a dW partial tile (many columns: one level), K16's batch sum of d(bias)
REDUCE_CASES = [(263, 2 * 768), (527, 2304), (685, 3072), (261, 3 * 768), (128, 3072),
                (2740, 768), (7, 768 * 2304), (4, 12 * 32 * 32), (1, 768), (9, 64)]


@pytest.mark.parametrize("s,n", REDUCE_CASES)
def test_reduce_order_matches_an_fp64_sum(s, n):
    rng = np.random.default_rng(s + n)
    cols = min(n, 4096)  # the order is per column: a slice of the columns suffices
    part = rng.standard_normal((s, cols)).astype(np.float32)
    per = tfl.reduce_split(s, n, 132)
    if per is not None:
        assert 2 <= -(-s // per) <= s // tfl._REDUCE_MIN_ROWS
        assert per >= tfl._REDUCE_MIN_ROWS
    if n >= 2 * 132 * tfl._REDUCE_COLS or s < 2 * tfl._REDUCE_MIN_ROWS:
        assert per is None  # the columns fill the card, or too few rows to split
    ref = part.astype(np.float64).sum(0)
    bound = s * 2.0**-23 * np.abs(part).astype(np.float64).sum(0)  # fp32 sums of s terms
    for split in (per, None, 3):  # the wrapper's choice, one level, a split of 3 rows
        got = _reduce_model(part, split)
        assert (np.abs(got - ref) <= bound + 1e-30).all(), split


def _rand(rng, *shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _jax_grads(fn, arrays, cot):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _check(got, ref, tol, names):
    assert len(got) == len(ref) == len(names)
    for g, r, name in zip(got, ref, names):
        g = g.numpy()
        assert g.dtype == np.float32 and g.shape == r.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol, err_msg=name)


def test_k6_twin_matches_jax_vjp_at_the_model_width():
    """K6 at D 768, 3D 2304 and 1370 rows (no multiple of any tile): the
    twin, which the wrapper runs on CPU tensors, against the JAX kernel."""
    n, d = 1370, 768
    rng = np.random.default_rng(6)
    arrays = (_rand(rng, n, d), _rand(rng, d, std=0.1, mean=1.0), _rand(rng, d, std=0.1),
              _rand(rng, d, 3 * d, std=0.02), _rand(rng, 3 * d, std=0.02))
    cot = _rand(rng, n, 3 * d)
    ref = _jax_grads(lambda *a: jfl.fused_preattn_vjp(*a, 1e-6), arrays, cot)
    launches = tfl.fused_preattn_bwd.launches
    got = tfl.fused_preattn_bwd(*map(torch.from_numpy, arrays), torch.from_numpy(cot), eps=1e-6)
    assert tfl.fused_preattn_bwd.launches == launches  # CPU tensors: the plain twin
    _check(got, ref, 2e-4, ("dx", "dln_scale", "dln_bias", "dw_qkv", "db_qkv"))


D, F = 128, 256


def test_k8_twin_matches_jax_vjp_at_ragged_rows():
    n = 131
    rng = np.random.default_rng(8)
    arrays = (_rand(rng, n, D), _rand(rng, n, D), _rand(rng, D, D, std=0.1),
              _rand(rng, D, std=0.1), _rand(rng, D, std=0.1, mean=0.7),
              _rand(rng, D, std=0.1, mean=1.0), _rand(rng, D, std=0.1),
              _rand(rng, D, F, std=0.1), _rand(rng, F, std=0.1), _rand(rng, F, D, std=0.1),
              _rand(rng, D, std=0.1), _rand(rng, D, std=0.1, mean=1.3))
    cot = _rand(rng, n, D)
    ref = _jax_grads(lambda *a: jfl.fused_postattn_vjp(*a, 1e-6), arrays, cot)
    got = tfl.fused_postattn_bwd(*map(torch.from_numpy, arrays), torch.from_numpy(cot), eps=1e-6)
    _check(got, ref, 2e-4, ("dx", "da", "dwo", "dbo", "dls1", "dln_scale", "dln_bias", "dw1",
                            "db1", "dw2", "db2", "dls2"))


def test_k9_twin_matches_jax_vjp_at_ragged_rows():
    n = 131
    rng = np.random.default_rng(9)
    arrays = (_rand(rng, n, D), _rand(rng, n, D), _rand(rng, D, D, std=0.1),
              _rand(rng, D, std=0.1), _rand(rng, D, std=0.1, mean=1.0), _rand(rng, D, std=0.1),
              _rand(rng, D, F, std=0.1), _rand(rng, F, std=0.1), _rand(rng, F, D, std=0.1),
              _rand(rng, D, std=0.1), _rand(rng, D, std=0.1, mean=1.3), _rand(rng, D, std=0.1))
    cot = _rand(rng, n, D)
    ref = _jax_grads(lambda *a: jfl.fused_mpnet_post_vjp(*a, 1e-12), arrays, cot)
    got = tfl.fused_mpnet_post_bwd(*map(torch.from_numpy, arrays), torch.from_numpy(cot),
                                   eps=1e-12)
    _check(got, ref, 5e-4, ("dx", "da", "dwo", "dbo", "dlnsa", "dlnba", "dw1", "db1", "dw2",
                            "db2", "dlnso", "dlnbo"))
