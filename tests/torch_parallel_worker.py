"""One rank of a gloo process group running the PyTorch port's parallel
paths for the tests (`test_torch_context_parallel.py`,
`test_torch_distributed.py`).

    python tests/torch_parallel_worker.py <rank> <world> <init file> <job.pt> <out dir>

Joins the group through `file://<init file>`, reads the job (a list of
scenarios written by the test with `torch.save`), runs each on a
`parallel.make_mesh` mesh of the CPU ranks and writes this rank's results
to <out dir>/rank<rank>.pt. Imports torch and the port only, never JAX.

Scenarios:
  * 'cp': `ring_attention` or `context_parallel_attention` on global q / k
    / v; returns the output, the gradients of (out ** 2).sum() and the
    chunk and plain-version call counts;
  * 'refuse': the messages of `ring_attention` and of a ring model's
    forward on a length the context size does not divide;
  * 'compare': the same `Trainer` options with and without the mesh (a
    flash model of the same weights), draws from seeded generators: each
    step's metrics of both, and `forward_modality`'s loss on both models;
  * 'trainer': `Trainer(mesh=)` steps on a packed batch with given draws
    from given weights (a flax tree of numpy arrays, `load_flax`); returns
    each step's metrics and the stored shards' shapes, and with
    'resume_after' the metrics of a run
    saved after that step, restored by a new Trainer and continued;
  * 'pipeline': the same with `Trainer(pipeline_microbatches=,
    pipeline_schedule=)` on a mesh with a 'pipe' axis, an optimizer by name
    ('muon_adam_atan2'), and this rank's stage computations per step (the
    engines' `stage_calls`);
  * 'pipeline_refuse': the message of each refused pipelined Trainer
    configuration.
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

from transfusion_tpu_torch.ops import flash_attn  # noqa: E402
from transfusion_tpu_torch.parallel import context, make_mesh  # noqa: E402


def count_plain_calls():
    """Count the flash forward's plain-version calls (what a CPU tensor's
    chunk call runs)."""
    plain = flash_attn.flash_attention_plain
    calls = {"n": 0}

    def counted(*args, **kw):
        calls["n"] += 1
        return plain(*args, **kw)

    flash_attn.flash_attention_plain = counted
    return calls


def run_cp(job, calls):
    mesh = make_mesh(**job["mesh"], device="cpu")
    fn = {"ring": context.ring_attention,
          "allgather": context.context_parallel_attention}[job["schedule"]]
    q, k, v = (job[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
    context.ring_attention.chunks.update(run=0, skipped=0)
    calls["n"] = 0
    out = fn(q, k, v, spans=job.get("spans"), causal=job.get("causal", False), mesh=mesh)
    fwd_calls = calls["n"]
    (out ** 2).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
            "chunks": dict(context.ring_attention.chunks), "plain_calls": fwd_calls}


def run_refuse(job):
    from transfusion_tpu_torch import Transfusion

    mesh = make_mesh(**job["mesh"], device="cpu")
    x = torch.zeros(1, 1, 34, 32)
    model = Transfusion(device="cpu", num_text_tokens=16, transformer=dict(
        dim=32, depth=1, dim_head=32, heads=1, attn_impl="ring", mesh=mesh))
    messages = []
    for call in (lambda: context.ring_attention(x, x, x, causal=True, mesh=mesh),
                 lambda: model.core.text_forward(torch.zeros((1, 6), dtype=torch.int64))):
        try:
            call()
        except ValueError as e:
            messages.append(str(e))
    return messages


def run_compare(job):
    from transfusion_tpu_torch import Transfusion
    from transfusion_tpu_torch.training import Trainer, adam_atan2

    mesh = make_mesh(**job["mesh"], device="cpu")
    tcfg = job["cfg"]["transformer"]
    models = {
        "mesh": Transfusion(device="cpu", **dict(job["cfg"], transformer=dict(
            tcfg, attn_impl=job["impl"], mesh=mesh))),
        "plain": Transfusion(device="cpu", **dict(job["cfg"], transformer=dict(
            tcfg, attn_impl="flash"))),
    }
    packs = [p.to_torch("cpu") for p in job["packed"]]
    res = {}
    for name, model in models.items():
        model.load_flax(job["flax"])
        kw = dict(job["trainer"], mesh=mesh if name == "mesh" else None)
        if job.get("optimizer") == "adam_atan2":
            kw["optimizer"] = adam_atan2(1e-3)
        trainer = Trainer(model, **kw)
        state, metrics = trainer.init_state(), []
        gen = torch.Generator().manual_seed(0)
        if job.get("train_steps"):
            state, met = trainer.train_steps(state, packs, 2, generator=gen)
            metrics.append(met)
        else:
            for _ in range(2):
                batch = packs if trainer.grad_accumulation else packs[0]
                state, met = trainer.train_step(state, batch, generator=gen)
                metrics.append(met)
        lat = torch.tensor(job["latents"])
        modality = model.forward_modality(lat, times=torch.full((lat.shape[0],), 0.3),
                                          noise=torch.ones_like(lat))
        res[name] = {"metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
                     "forward_modality": float(modality)}
    return res


def run_trainer(job, path):
    from transfusion_tpu_torch import Transfusion
    from transfusion_tpu_torch.parallel.pipeline import pipeline_blocks
    from transfusion_tpu_torch.parallel.pipeline_1f1b import pipeline_1f1b_grads
    from transfusion_tpu_torch.training import Trainer, muon_adam_atan2

    mesh = make_mesh(**job["mesh"], device="cpu")
    cfg = dict(job["cfg"])
    cfg["transformer"] = dict(cfg["transformer"], mesh=mesh)
    model = Transfusion(device="cpu", **cfg)
    model.load_flax(job["flax"])
    kw = dict(job["trainer"], mesh=mesh)
    if job.get("optimizer") == "muon_adam_atan2":
        kw["optimizer"] = muon_adam_atan2(1e-3, 3e-4)
    packed = job["packed"].to_torch("cpu")
    stage_calls = []

    def run(trainer, state, draws):
        out = []
        for d in draws:
            pipeline_blocks.stage_calls.update(forward=0, backward=0)
            pipeline_1f1b_grads.stage_calls.update(forward=0, backward=0, head=0)
            state, met = trainer.train_step(state, packed, draws=d)
            out.append({k: float(v) for k, v in met.items()})
            stage_calls.append({"gpipe": dict(pipeline_blocks.stage_calls),
                                "1f1b": dict(pipeline_1f1b_grads.stage_calls)})
        return state, out

    trainer = Trainer(model, **kw)
    state, metrics = run(trainer, trainer.init_state(), job["draws"])
    res = {"metrics": metrics, "shapes": {k: tuple(v.shape) for k, v in state.params.items()},
           "stage_calls": stage_calls}
    after = job.get("resume_after")
    if after is not None:
        ck = os.path.join(path, job["name"])
        first = Trainer(model, checkpoint_dir=ck, **kw)
        state, _ = run(first, first.init_state(), job["draws"][:after])
        first.save(state)
        second = Trainer(model, checkpoint_dir=ck, **kw)
        restored = second.restore()
        res["restored_equal"] = all(
            torch.equal(restored.params[k], state.params[k]) for k in state.params) and all(
            torch.equal(restored.ema.params[k], state.ema.params[k]) for k in state.params)
        _, res["resumed"] = run(second, restored, job["draws"][after:])
    return res


def run_pipeline_refuse(job):
    """{case: the message of the ValueError that Trainer(...) raised}."""
    from transfusion_tpu_torch import Transfusion
    from transfusion_tpu_torch.training import Trainer

    out = {}
    for name, case in job["cases"].items():
        mesh = None if case["mesh"] is None else make_mesh(**case["mesh"], device="cpu")
        model = Transfusion(device="cpu", **dict(job["cfg"], transformer=case["transformer"]))
        try:
            Trainer(model, mesh=mesh, **case["trainer"])
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def main():
    rank, world, init_file, job_path, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    calls = count_plain_calls()
    results = {}
    try:
        for job in torch.load(job_path, weights_only=False):
            if job["kind"] == "cp":
                results[job["name"]] = run_cp(job, calls)
            elif job["kind"] == "refuse":
                results[job["name"]] = run_refuse(job)
            elif job["kind"] == "compare":
                results[job["name"]] = run_compare(job)
            elif job["kind"] == "pipeline_refuse":
                results[job["name"]] = run_pipeline_refuse(job)
            else:  # 'trainer' and 'pipeline'
                results[job["name"]] = run_trainer(job, out_dir)
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
