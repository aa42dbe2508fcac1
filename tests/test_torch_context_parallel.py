"""PyTorch port: context-parallel attention (`parallel/context.py`) against
the JAX package's `ring_attention` / `context_parallel_attention` and the
dense oracle, in float32 on the CPU.

The port runs in 4 gloo processes (`torch_parallel_worker.py`, no JAX),
each scenario on a `make_mesh(context=4)` mesh (P 4) or a `make_mesh(data=2,
context=2)` one (P 2: each data pair computes the same thing). The JAX
side runs here on the virtual CPU devices of `conftest.py`, its Pallas
kernels in interpret mode. Inputs come from a seeded numpy generator.

Tolerances (float32): outputs within 2e-5 of JAX's schedule and of the
dense oracle, as `tests/test_context_parallel.py` holds JAX's; dq / dk /
dv of (out ** 2).sum() within 1e-4 (JAX's `test_cp_kernel_path_grads`
holds its kernel path at 3e-4, `test_ring_attention_grads` at 1e-4).

Head dim 32 at nl 16 / 32 takes the flash route (the plain version on CPU
tensors); head dim 16, or no structural mask, the dense online update.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from transfusion_tpu.ops.pallas_attn import _reference_attention
from transfusion_tpu.parallel.context import context_parallel_attention as j_allgather
from transfusion_tpu.parallel.context import ring_attention as j_ring
from transfusion_tpu_torch import Transfusion

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
START_TIMEOUT = 120  # seconds for a whole group to run its job


def launch(tmp_path, world: int, jobs: list, timeout: int = START_TIMEOUT) -> list:
    """Run `jobs` on `world` gloo ranks (file:// rendezvous under tmp_path);
    returns each rank's results. A group that does not finish within
    `timeout` seconds is killed and fails the test."""
    job = tmp_path / "job.pt"
    torch.save(jobs, job)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(tmp_path / "init"),
                               str(job), str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a gloo group of {world} did not finish within {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


SPANS = np.asarray([[[0, 10, 20], [1, 40, 12]], [[0, 5, 30], [0, 0, 0]]], np.int32)
MASKS = {"spans": dict(spans=SPANS, causal=False), "causal": dict(spans=None, causal=True),
         "nomask": dict(spans=None, causal=False)}
# (schedule, P, mask, head dim)
CASES = [(s, p, m, 32) for s in ("ring", "allgather") for p in (2, 4) for m in MASKS]
CASES += [("ring", 4, "spans", 16), ("allgather", 2, "spans", 16)]


def qkv(d, seed=0, b=2, h=2, n=64):
    rng = np.random.default_rng(seed + d)
    return tuple((rng.standard_normal((b, h, n, d)) * 0.5).astype(np.float32) for _ in range(3))


def name(case):
    return "-".join(map(str, case))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    jobs = []
    for case in CASES:
        sched, P, mask, d = case
        q, k, v = qkv(d)
        spans = MASKS[mask]["spans"]
        jobs.append(dict(kind="cp", name=name(case), schedule=sched,
                         mesh=dict(context=4) if P == 4 else dict(data=2, context=2),
                         q=torch.tensor(q), k=torch.tensor(k), v=torch.tensor(v),
                         spans=None if spans is None else torch.tensor(spans),
                         causal=MASKS[mask]["causal"]))
    jobs.append(dict(kind="refuse", name="indivisible", mesh=dict(context=4)))
    return launch(tmp_path_factory.mktemp("cp"), 4, jobs)


def jax_mesh(P):
    return Mesh(np.asarray(jax.devices()[:P]), axis_names=("context",))


@pytest.mark.parametrize("case", CASES, ids=[name(c) for c in CASES])
def test_schedule_matches_jax_and_oracle(port_runs, case):
    """Output within 2e-5 of JAX's schedule and of the dense oracle on
    every rank, and dq / dk / dv within 1e-4 of the oracle's."""
    sched, P, mask, d = case
    ranks = port_runs
    q, k, v = (jnp.asarray(t) for t in qkv(d))
    spans = None if MASKS[mask]["spans"] is None else jnp.asarray(MASKS[mask]["spans"])
    causal = MASKS[mask]["causal"]
    fn = j_ring if sched == "ring" else j_allgather
    want_cp = np.asarray(fn(q, k, v, spans=spans, causal=causal, mesh=jax_mesh(P)))

    def oracle(q, k, v):
        return (_reference_attention(q, k, v, spans, causal, 50.0) ** 2).sum()

    want = np.asarray(_reference_attention(q, k, v, spans, causal, 50.0))
    grads = jax.grad(oracle, argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(want_cp, want, atol=2e-5)
    for r, res in enumerate(ranks):
        got = res[name(case)]
        assert np.isfinite(got["out"].numpy()).all()
        np.testing.assert_allclose(got["out"].numpy(), want_cp, atol=2e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["out"].numpy(), want, atol=2e-5, err_msg=f"rank {r}")
        for g, w in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[g].numpy(), np.asarray(w), atol=1e-4,
                                       err_msg=f"rank {r} {g}")


@pytest.mark.parametrize("sched", ["ring", "allgather"])
def test_kernel_path_grads_match_jax(port_runs, sched):
    """dq / dk / dv of JAX's own schedule on its flash-kernel path (P 2,
    spans, d 32) against the port's, within 1e-4."""
    ranks = port_runs
    case = (sched, 2, "spans", 32)
    q, k, v = (jnp.asarray(t) for t in qkv(32))
    fn = j_ring if sched == "ring" else j_allgather
    mesh, spans = jax_mesh(2), jnp.asarray(SPANS)
    grads = jax.grad(lambda q, k, v: (fn(q, k, v, spans=spans, mesh=mesh) ** 2).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(ranks[0][name(case)][g].numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=g)


def test_skipped_chunks_launch_nothing(port_runs):
    """Causal ring at P 4: rank r runs the chunks of ranks 0..r (r + 1 plain
    calls in the forward) and skips the P - 1 - r later ones; the
    all-gather schedule makes one call a rank. With spans, a chunk a span
    rectangle spills into is run: rank 0 (rows 0-15) sees columns 16-29
    through the span at 10 of length 20."""
    ranks = port_runs
    for r, res in enumerate(ranks):
        ring = res[name(("ring", 4, "causal", 32))]
        assert ring["plain_calls"] == r + 1 and ring["chunks"] == {"run": r + 1,
                                                                   "skipped": 3 - r}
        assert res[name(("allgather", 4, "causal", 32))]["plain_calls"] == 1
        nomask = res[name(("ring", 4, "nomask", 32))]
        assert nomask["chunks"] == {"run": 4, "skipped": 0} and nomask["plain_calls"] == 0
    spans0 = ranks[0][name(("ring", 4, "spans", 32))]
    assert spans0["chunks"] == {"run": 3, "skipped": 1}  # chunks 0, 1 (span) and 2 (span 40)


def test_row_masked_in_all_chunks_but_one():
    """A row that sees no column of a chunk gets lse ~ -1e30 from the plain
    version (the kernel's sentinel, held on the card by chip_smoke.py), and
    the merge keeps it finite: rank 0's rows 0-9 (P 4, nl 16) see only
    chunk 0, yet chunk 1 runs for its rows 10-15. The merge over chunks 0
    and 1 equals the plain version over both."""
    from transfusion_tpu_torch.ops import flash_attn
    from transfusion_tpu_torch.parallel import context

    q, k, v = (torch.tensor(t) for t in qkv(32))
    spans = torch.tensor(SPANS)
    nl = 16
    _, lse1 = flash_attn.flash_attention_plain(q[:, :, :nl], k[:, :, nl:2 * nl],
                                               v[:, :, nl:2 * nl], spans, 50.0, 0, nl)
    assert (lse1[0, :, :10] < -1e29).all() and (lse1[0, :, 10:] > -1e29).all()
    assert context.chunk_need(0, 4, nl, spans, False) == [True, True, True, False]
    state = context.ring_init(q[:, :, :nl], True)
    for src in (0, 1):
        state = context.ring_step(state, q[:, :, :nl], k[:, :, src * nl:(src + 1) * nl],
                                  v[:, :, src * nl:(src + 1) * nl], spans, False, 50.0, 0,
                                  src * nl, True)
    out = context.ring_finish(state, q.dtype, True)
    want, _ = flash_attn.flash_attention_plain(q[:, :, :nl], k[:, :, :2 * nl],
                                               v[:, :, :2 * nl], spans, 50.0, 0, 0)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5)


def test_refusals(port_runs):
    """n not divisible by the context size (ring_attention itself, and a
    ring model's forward), and dropout with a CP schedule, are refused with
    JAX's words."""
    for res in port_runs:
        assert len(res["indivisible"]) == 2
        assert all("divisible by the context" in msg for msg in res["indivisible"])
    cfg = dict(num_text_tokens=16, dim_latent=8, modality_default_shape=(2, 2), pad_multiple=16)
    with pytest.raises(ValueError, match="dropout"):
        Transfusion(transformer=dict(dim=32, depth=1, dim_head=16, heads=2, dropout=0.1,
                                     attn_impl="ring"), device="cpu", **cfg)
