"""PyTorch / CUDA port of `transfusion_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout and
names (`ops/`, `models/`, `data/`, `utils/`) so each module's counterpart is
easy to find. It imports `torch` and never `jax` or `transfusion_tpu`.

Slice 1 covers the KV-cached serving path:

  * `Transfusion.generate_text_only` / `generate_text_batch` (ragged batched
    text serving);
  * `Transfusion.sample(cache_kv=True)` (the multimodal AR <-> ODE state
    machine with CFG over one KV cache).

Its two attention kernels are hand-written CUDA for `sm_90a`
(`csrc/flash_fwd.cu`, `csrc/decode_attn.cu`), built with `nvcc` at first use
(`ops/_build.py`). On CPU tensors every kernel wrapper takes its plain
PyTorch version instead.
"""

from transfusion_tpu_torch.models.transfusion import Transfusion

__all__ = ["Transfusion"]
