"""The port's process group and collectives (radzero_torch/parallel) on the
CPU, two gloo ranks, against one-process references and the JAX package.

- ``all_gather_rows``: the forward is the rank-order concatenation, the
  backward the sum over the ranks of each rank's upstream gradient, in
  fp32 and bf16 (summed in fp32, rounded once);
- ``gather_rows`` on integer and float tensors, and ``average_gradients``:
  the mean over the ranks by one all-reduce, the same bits on both ranks;
- ``init_distributed``: no environment is a world of one; an incomplete
  launcher environment, partial arguments and an explicit rendezvous that
  no peer joins raise; ``check_mesh`` against the world (a data and a model
  axis);
- ``vlcabs_similarity(group=)``, impls ``xla`` and ``fused_train`` (the
  K10-K12 twins), against the JAX ``shard_map`` path on a 2-device CPU
  mesh (``tests/test_parallel_train.py``): logits at 1e-5; dq and dt
  against ``jax.vjp`` at 1e-4. Each rank computes the same global value,
  so each gather's backward counts a rank's own share P times: dq and dt
  are P times the JAX rows and the ranks' dtau average to JAX's.

The ranks are fresh interpreters running this file (``run_ranks``), which
rendezvous through a ``file://`` store under the test's directory; each
rank's log is a file, and every log is printed when a rank fails.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from radzero_torch.parallel import dist as pdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 240


def run_ranks(tmp_path, script, mode, world=WORLD, timeout_s=TIMEOUT_S, args=()):
    """Run ``python script mode rank world file://store out args`` once a rank,
    all at once; fail with every rank's log when one exits non-zero or the
    ranks outlive ``timeout_s``."""
    out = tmp_path / mode
    out.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        logs.append(out / f"rank{r}.log")
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, script, mode, str(r), str(world),
                 f"file://{out / 'store'}", str(out), *map(str, args)],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        text = "\n".join(f"--- rank {r} (exit {c}) ---\n{log.read_text()[-6000:]}"
                         for r, (c, log) in enumerate(zip(codes, logs)))
        raise AssertionError(f"{mode}: ranks exited {codes}\n{text}")
    return out


def rank_main(modes):
    """The entry of a rank process: argv = mode rank world init out [args]."""
    mode, r, world, init, out, *rest = sys.argv[1:]
    torch.set_num_threads(1)
    if mode in SOLO:
        modes[mode](int(r), int(world), init, out, *rest)
        return
    group = pdist.init_distributed(backend="gloo", init_method=init, rank=int(r),
                                   world_size=int(world), timeout_s=60)
    try:
        modes[mode](group, out, *rest)
    finally:
        torch.distributed.destroy_process_group()


SOLO = ("bad_rendezvous",)

# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

N_ROWS, D = 3, 5   # rows a rank of the gather cases
S, B, L, DV = 6, 4, 10, 64  # the VL-CABS case: S queries, B images over the ranks


def _gather_inputs(r):
    g = np.random.default_rng(100 + r)
    return (g.standard_normal((N_ROWS, D)).astype(np.float32),
            g.standard_normal((WORLD * N_ROWS, D)).astype(np.float32))


def _vlcabs_inputs():
    g = np.random.default_rng(7)
    return (g.standard_normal((S, DV)).astype(np.float32),
            g.standard_normal((B, L, DV)).astype(np.float32),
            g.standard_normal((S, B)).astype(np.float32), np.float32(0.07))


def _collectives_rank(group, out):
    from radzero_torch.parallel import collectives as pc
    from radzero_torch.ops.vlcabs import vlcabs_similarity

    r = pdist.rank(group)
    res = {}
    x, up = _gather_inputs(r)
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        y = pc.all_gather_rows(xt, group)
        y.backward(torch.tensor(up, dtype=dtype))
        res[f"gather_{name}"] = y.detach().float()
        res[f"grad_{name}"] = xt.grad.float()
        res[f"grad_dtype_{name}"] = str(xt.grad.dtype)
    res["gather_int"] = pc.gather_rows(torch.arange(3) + 10 * r, group)
    res["gather_nograd"] = pc.gather_rows(torch.tensor(x), group)

    calls = []
    all_reduce = pc.dist.all_reduce
    pc.dist.all_reduce = lambda *a, **k: (calls.append(1), all_reduce(*a, **k))[1]
    try:
        grads = [torch.tensor(x) * (r + 1), torch.arange(7.0) ** (r + 1),
                 torch.full((2, 2, 2), 0.1 * (r + 1))]
        res["averaged"] = pc.average_gradients(grads, group)
    finally:
        pc.dist.all_reduce = all_reduce
    res["all_reduce_calls"] = len(calls)
    res["offset"] = pdist.process_offset(32, group)
    pdist.sync("test", group)

    q, t, w, tau = _vlcabs_inputs()
    rows, imgs = slice(r * S // WORLD, (r + 1) * S // WORLD), slice(r * B // WORLD,
                                                                   (r + 1) * B // WORLD)
    for impl in ("xla", "fused_train"):
        tq = torch.tensor(q[rows], requires_grad=True)
        tt = torch.tensor(t[imgs], requires_grad=True)
        ttau = torch.tensor(tau, requires_grad=True)
        logits, scores = vlcabs_similarity(tq, tt, sim_op="cos", temperature=ttau, impl=impl,
                                           group=group)
        assert scores is None
        (torch.from_numpy(w) * logits).sum().backward()
        res[f"vl_{impl}"] = (logits.detach(), tq.grad, tt.grad, ttau.grad)
    with pytest.raises(ValueError, match="need_scores"):
        vlcabs_similarity(torch.tensor(q[rows]), torch.tensor(t[imgs]), temperature=torch.tensor(
            tau), need_scores=True, group=group)
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def _bad_rendezvous(r, world, init, out):
    """Rank 0 alone of a declared world of 2: init must raise, not run alone."""
    t0 = time.monotonic()
    try:
        pdist.init_distributed(backend="gloo", init_method=init, rank=0, world_size=2,
                               timeout_s=3)
    except Exception as e:  # the rendezvous' own error type
        print(f"raised {type(e).__name__} after {time.monotonic() - t0:.1f} s: {e}")
        return
    raise SystemExit("init_distributed returned for a world that never assembled")


MODES = {"collectives": _collectives_rank, "bad_rendezvous": _bad_rendezvous}

# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = run_ranks(tmp_path_factory.mktemp("parallel"), __file__, "collectives")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_all_gather_rows_forward_and_backward(ranks, dtype):
    xs, ups = zip(*(_gather_inputs(r) for r in range(WORLD)))
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    cat = torch.cat([torch.tensor(x, dtype=tdt).float() for x in xs])
    summed = sum(torch.tensor(u, dtype=tdt).float() for u in ups)  # the fp32 sum, rounded once
    for r, res in enumerate(ranks):
        assert torch.equal(res[f"gather_{dtype}"], cat)
        want = summed[r * N_ROWS:(r + 1) * N_ROWS].to(tdt).float()
        assert torch.equal(res[f"grad_{dtype}"], want)
        assert res[f"grad_dtype_{dtype}"] == str(tdt)


def test_gather_rows_and_offsets(ranks):
    xs = [torch.tensor(_gather_inputs(r)[0]) for r in range(WORLD)]
    for r, res in enumerate(ranks):
        assert res["gather_int"].tolist() == [0, 1, 2, 10, 11, 12]
        assert torch.equal(res["gather_nograd"], torch.cat(xs))
        assert res["offset"] == 32 * r


def test_average_gradients_is_one_all_reduce(ranks):
    x = _gather_inputs(0)[0]
    x1 = _gather_inputs(1)[0]
    want = [(torch.tensor(x) * 1 + torch.tensor(x1) * 2) / 2,
            (torch.arange(7.0) + torch.arange(7.0) ** 2) / 2, torch.full((2, 2, 2), 0.15)]
    for res in ranks:
        assert res["all_reduce_calls"] == 1
        for got, ref in zip(res["averaged"], want):
            assert got.shape == ref.shape and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)
    for a, b in zip(ranks[0]["averaged"], ranks[1]["averaged"]):
        assert torch.equal(a, b)


def test_init_distributed_world_of_one_and_refusals(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert pdist.init_distributed() is None
    assert pdist.world(None) == 1 and pdist.rank(None) == 0
    assert pdist.process_offset(64, None) == 0
    pdist.sync("nothing to wait for", None)
    with pytest.raises(ValueError, match="together"):
        pdist.init_distributed(init_method="file:///nowhere", rank=0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        pdist.init_distributed()
    assert not torch.distributed.is_initialized()


def test_explicit_rendezvous_without_peers_raises(tmp_path):
    out = run_ranks(tmp_path, __file__, "bad_rendezvous", world=1, timeout_s=120)
    assert "raised" in (out / "rank0.log").read_text()


def test_check_mesh():
    assert pdist.check_mesh({"data": -1}, 4) == 4
    assert pdist.check_mesh(None, 2) == 2
    assert pdist.check_mesh({"data": 2}, 2) == 2
    assert pdist.check_mesh({"data": 1, "model": 1}, 1) == 1
    with pytest.raises(ValueError, match="world"):
        pdist.check_mesh({"data": 4}, 2)
    with pytest.raises(ValueError, match="world"):
        pdist.check_mesh({"data": 2}, 1)
    assert pdist.check_mesh({"data": -1, "model": 2}, 2) == 1  # a model axis: data absorbs the rest
    with pytest.raises(NotImplementedError, match="data and model"):
        pdist.check_mesh({"data": -1, "pipe": 2}, 2)


@pytest.mark.parametrize("impl", ["xla", "fused_train"])
def test_vlcabs_group_matches_jax_shard_map(ranks, impl):
    import jax
    import jax.numpy as jnp

    from radzero_tpu.ops.vlcabs import vlcabs_similarity as jax_vlcabs
    from radzero_tpu.parallel.mesh import create_mesh

    q, t, w, tau = _vlcabs_inputs()
    mesh = create_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])

    def fn(q_, t_, tau_):
        return jax_vlcabs(q_, t_, sim_op="cos", temperature=tau_, impl="fused_train",
                          mesh=mesh)[0]

    logits, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(t), jnp.float32(tau))
    dq, dt, dtau = (np.asarray(a) for a in vjp(jnp.asarray(w)))
    dtaus = []
    for r, res in enumerate(ranks):
        got_logits, got_dq, got_dt, got_dtau = res[f"vl_{impl}"]
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), rtol=1e-5, atol=1e-5)
        rows, imgs = slice(r * S // WORLD, (r + 1) * S // WORLD), slice(r * B // WORLD,
                                                                       (r + 1) * B // WORLD)
        np.testing.assert_allclose(got_dq.numpy(), WORLD * dq[rows], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got_dt.numpy(), WORLD * dt[imgs], rtol=1e-4, atol=1e-4)
        dtaus.append(got_dtau.item())
    np.testing.assert_allclose(np.mean(dtaus), dtau, rtol=1e-4, atol=1e-4)


if __name__ == "__main__":
    rank_main(MODES)
