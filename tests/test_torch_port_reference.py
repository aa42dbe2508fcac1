"""PyTorch port: the transfusion-pytorch checkpoint loader (`models/port.py`)
on the CPU, against the reference-shaped twin module of tests/test_port.py
(the reference's state_dict key layout and forward math) and against the
JAX loader: `port_from_reference` gives, entry by entry and bit-exact,
what `weights.from_flax` gives for the JAX `port_from_reference`; the
ported model's text logits and modality forward are within 1e-4 of the
twin's; export round-trips; the key maps agree across configurations; and
the strict refusals hold."""

import jax
import numpy as np
import pytest
import torch
from test_port import (
    DEPTH,
    DH,
    DIM,
    DIM_LATENT,
    HEADS,
    VOCAB_TEXT,
    _flax_model,
    _randomized_ref,
)

from transfusion_tpu.models.port import export_to_reference as j_export
from transfusion_tpu.models.port import port_from_reference as j_port
from transfusion_tpu.models.port import reference_key_map as j_key_map
from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.models.modality_io import SameConv2d, SameConvTranspose2d
from transfusion_tpu_torch.models.port import (
    export_to_reference,
    port_from_reference,
    reference_key_map,
)
from transfusion_tpu_torch.weights import from_flax

torch.set_num_threads(1)


def port_model(**kw):
    cfg = dict(num_text_tokens=VOCAB_TEXT, dim_latent=DIM_LATENT, modality_default_shape=(2,),
               transformer=dict(dim=DIM, depth=DEPTH, dim_head=DH, heads=HEADS), pad_multiple=16)
    cfg.update(kw)
    return Transfusion(device="cpu", **cfg)


def test_port_matches_the_jax_loader_entry_by_entry():
    ref = _randomized_ref()
    tm = port_model()
    got = port_from_reference(ref.state_dict(), tm)
    want = from_flax(jax.tree.map(np.asarray, j_port(ref.state_dict(), _flax_model())), tm)
    assert set(got) == set(want) == set(tm.core.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the model holds them, the time-embedding frequencies included
    assert torch.equal(tm.core.transformer.fourier_weights,
                       ref.transformer.to_time_cond[0].weights)
    assert all(torch.equal(v, got[k]) for k, v in tm.core.state_dict().items())


def test_ported_logits_match_the_reference_twin():
    ref = _randomized_ref()
    tm = port_model()
    port_from_reference(ref.state_dict(), tm)
    ids = np.random.default_rng(0).integers(0, VOCAB_TEXT, (2, 12)).astype(np.int64)
    want = ref.forward_text_logits(torch.tensor(ids)).detach()
    torch.testing.assert_close(tm.forward_text(ids, return_loss=False), want, rtol=0, atol=1e-4)
    rng = np.random.default_rng(1)
    rows = torch.tensor(rng.standard_normal((2, 3, DIM_LATENT)).astype(np.float32))
    times = torch.tensor([0.25, 0.8])
    want = ref.forward_modality_out(rows, times).detach()
    torch.testing.assert_close(tm.core.modality_forward(rows, times, 0), want, rtol=0,
                               atol=1e-4)


def test_export_round_trip():
    ref = _randomized_ref()
    sd = ref.state_dict()
    tm = port_model()
    port_from_reference(sd, tm)
    back = export_to_reference(tm)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float()), k
    jback = j_export(j_port(sd, _flax_model()), _flax_model())
    assert set(jback) == set(back)
    for k, v in jback.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # a trainer state's masters (parameters without buffers) export too
    masters = {k: p.detach().clone() for k, p in tm.core.named_parameters()}
    assert all(torch.equal(export_to_reference(tm, masters)[k], back[k]) for k in back)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(channel_first_latent=True),
    dict(dim_latent=DIM),
    dict(transformer=dict(dim=16, depth=3, dim_head=8, heads=2, unet_skips=False)),
    dict(transformer=dict(dim=16, depth=2, dim_head=8, heads=2, attn_gate_values=False)),
])
def test_key_map_matches_jax(opts):
    kw = dict(num_text_tokens=8, dim_latent=8, modality_default_shape=(2,),
              transformer=dict(dim=16, depth=2, dim_head=8, heads=2), pad_multiple=8)
    kw.update(opts)
    jm, tm = JaxTransfusion(**kw), Transfusion(device="cpu", **kw)
    got = [ref for ref, _ in reference_key_map(tm)]
    assert len(set(got)) == len(got)
    assert sorted(got) == sorted(ref for ref, *_ in j_key_map(jm))
    assert {k for _, k in reference_key_map(tm)} == set(tm.core.state_dict())


def test_strict_refusals():
    ref = _randomized_ref()
    sd = dict(ref.state_dict())
    with pytest.raises((KeyError, ValueError)):  # the checkpoint has one layer fewer
        port_from_reference(sd, port_model(transformer=dict(dim=DIM, depth=DEPTH + 1,
                                                            dim_head=DH, heads=HEADS)))
    missing = {k: v for k, v in sd.items() if k != "transformer.norm.gamma"}
    with pytest.raises(KeyError, match="transformer.norm.gamma"):
        port_from_reference(missing, port_model())
    tm = port_model()
    before = tm.core.transformer.final_norm.gamma.clone()
    port_from_reference(missing, tm, strict=False)  # keeps the model's own value
    assert torch.equal(tm.core.transformer.final_norm.gamma, before)
    extra = dict(sd, **{"transformer.layers.9.1.fn.to_v.0.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="unrecognized"):
        port_from_reference(extra, port_model())
    port_from_reference(dict(sd, **{"modality_encoder.0.weight": torch.zeros(1)}), port_model())
    bad = dict(sd, **{"rotary_emb.freqs": sd["rotary_emb.freqs"] * 2})
    with pytest.raises(ValueError, match="rotary"):
        port_from_reference(bad, port_model())
    shape = dict(sd, **{"text_embed.weight": torch.zeros(3, DIM)})
    with pytest.raises(ValueError, match="shape mismatch"):
        port_from_reference(shape, port_model())
    for kw, match in ((dict(transformer=dict(dim=DIM, depth=DEPTH, dim_head=DH, heads=HEADS,
                                             num_residual_streams=2)), "streams"),
                      (dict(add_pos_emb=True, modality_num_dim=1), "positional"),
                      (dict(pre_post_transformer_enc_dec=(SameConv2d(8, DIM),
                                                          SameConvTranspose2d(DIM, 8)),
                            modality_default_shape=(2, 2)), "pre_post")):
        with pytest.raises(ValueError, match=match):
            port_from_reference(sd, port_model(**kw))
