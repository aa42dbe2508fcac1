"""PyTorch / CUDA port of `transfusion_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout and
names (`ops/`, `models/`, `data/`, `utils/`) so each module's counterpart is
easy to find. It imports `torch` and never `jax` or `transfusion_tpu`.

The port goes slice by slice (ROADMAP.md):

  * serving: `Transfusion.generate_text_only` / `generate_text_batch`
    (ragged batched text serving) and `Transfusion.sample(cache_kv=True)`
    (the multimodal AR <-> ODE state machine with CFG over one KV cache);
  * training: `Transfusion.loss` and `training.Trainer.train_step` (the
    joint CE + flow loss, fused clip + Adam + EMA), on the token-major and
    head-major attention routes;
  * long-context training: per-block remat, chunked CE and exact gradient
    accumulation (`Trainer(grad_accumulation=M)`), at n 16384 on the 573M
    config;
  * uncached and batched sampling: `Transfusion.sample()` (cache_kv=False),
    `sample_batch` (`models/sample_batch.py`), `generate_modality_only`,
    `forward_text` / `forward_modality` and the adaptive ODE;
  * continuous-batching serving: `models.engine.ServingEngine` (text) and
    `models.engine_mm.MultimodalServingEngine` (text + image requests), one
    pooled KV cache each, with the dispatch planners of `models/serving.py`
    (`plan_dispatch`, `plan_dispatch_mm`) choosing between them and static
    batching from a cost model `warmup()` fits on the card;
    `training.metrics.MetricsLogger` logs their ticks;
  * image models: modality encoders / decoders, U-Net pre / post
    projections, the axial position embedding, and the reconstruction and
    velocity-consistency losses;
  * the example recipes' options: LASER attention, multi-stream
    hyper-connections, fused projections, the optimizers of
    `training/optim.py` behind `Trainer(optimizer=)`, metrics and profiler
    windows, `Transfusion.create_ema` and `muon_parameters`;
  * the single-process user surface: the data loaders and offline
    datasets (`data/`), the transfusion-pytorch checkpoint loader
    (`models/port.py`), module-level dropout, the remaining helpers
    (`ops/spans.py`, `utils/helpers.py`, `utils/typing.py`) and twins of the
    example scripts (`examples/`, `python -m
    transfusion_tpu_torch.examples.<name>`).

Every TPU kernel on these paths has a hand-written CUDA kernel for
`sm_90a` (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`: bf16 on the tensor
cores, float32 on FMAs; `csrc/decode_attn.cu`), built with `nvcc` at first
use (`ops/_build.py`). On CPU tensors every kernel wrapper takes its plain
PyTorch version instead.
"""

from transfusion_tpu_torch.models.transfusion import Transfusion

__all__ = ["Transfusion"]
