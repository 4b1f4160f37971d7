"""Port of ``repro/models/api.py``: the :class:`Model` facade, one uniform
interface over every architecture of the reference (the dense, VLM,
MoE, hybrid, SSM and enc-dec families).

``build_model(cfg)`` returns a :class:`Model` with
``init(generator, dtype, device)`` / ``param_shapes`` / ``loss`` /
``prefill`` / ``decode`` / ``input_specs(shape)`` / ``state_specs(shape)``
/ ``demo_batch``.  Parameters are an :class:`~repro_torch.models.
transformer.LMParams` module (an enc-dec model's a :class:`~repro_torch.
models.whisper.WhisperParams`); inputs are dicts of tensors, as in the
reference (an enc-dec model also takes ``frames``, (B, encoder_seq,
d_model) stub frame embeddings, bf16 in the specs).  ``input_specs`` and
``state_specs`` return tensors on the ``meta`` device — shapes and dtypes
without storage, the counterpart of ``ShapeDtypeStruct`` — and
``state_specs`` runs ``prefill`` on meta tensors, as the reference runs
``eval_shape``.  An unknown family raises
``ValueError`` at ``build_model``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.models import whisper as WH
from repro_torch.models.plan import ExecPlan

__all__ = ["Model", "build_model"]


def _meta(*shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ------------------------------------------------------------------ init
    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32, device=None):
        """Parameters drawn from ``generator`` (a CPU generator, seed 0 when
        None, or a CUDA generator, which draws on its card) in the
        reference's distributions, on ``device`` (``cuda`` unless ``"cpu"``
        is asked for)."""
        init = WH.init_params if self._encdec else T.init_params
        return init(self.cfg, generator, dtype, device)

    def param_shapes(self, dtype: torch.dtype = torch.float32):
        """The parameters on the ``meta`` device: shapes, no storage."""
        with torch.device("meta"):
            return self.init(dtype=dtype, device="meta")

    # ------------------------------------------------------------------ steps
    def loss(self, params, batch: dict, plan: ExecPlan):
        if self._encdec:
            return WH.lm_loss(params, batch, self.cfg, plan)
        return T.lm_loss(params, batch, self.cfg, plan)

    def prefill(self, params, inputs: dict, plan: ExecPlan,
                cache_capacity: int = 0):
        if self._encdec:
            return WH.prefill(params, self.cfg, plan, inputs["tokens"],
                              inputs["frames"], cache_capacity)
        return T.prefill(params, self.cfg, plan, inputs["tokens"],
                         inputs.get("patch_feats"), cache_capacity)

    def decode(self, params, token: torch.Tensor, state: dict,
               plan: ExecPlan):
        if self._encdec:
            return WH.decode_step(params, self.cfg, plan, token, state)
        return T.decode_step(params, self.cfg, plan, token, state)

    # ------------------------------------------------------------- input specs
    def _token_len(self, shape: ShapeSpec) -> int:
        """Text-token length for a cell (a VLM reserves room for patches)."""
        s = shape.seq_len - (self.cfg.vision_patches or 0)
        if s <= 0:
            raise ValueError(f"seq {shape.seq_len} too short for the "
                             f"{self.cfg.vision_patches}-patch vision prefix")
        return s

    def _extra_specs(self, b: int) -> dict:
        """The inputs beside the tokens: an enc-dec model's ``frames``, a
        VLM's ``patch_feats``, bf16 as in the reference."""
        cfg = self.cfg
        out = {}
        if self._encdec:
            out["frames"] = _meta(b, cfg.encoder_seq, cfg.d_model,
                                  dtype=torch.bfloat16)
        if cfg.vision_patches:
            out["patch_feats"] = _meta(b, cfg.vision_patches, cfg.vision_dim,
                                       dtype=torch.bfloat16)
        return out

    def input_specs(self, shape: ShapeSpec) -> dict:
        """Meta-device stand-ins for every input of one benchmark cell."""
        b, s = shape.global_batch, self._token_len(shape)
        if shape.kind == "train":
            return {"tokens": _meta(b, s, dtype=torch.int32),
                    "labels": _meta(b, s, dtype=torch.int32),
                    **self._extra_specs(b)}
        if shape.kind == "prefill":
            return {"tokens": _meta(b, s, dtype=torch.int32),
                    **self._extra_specs(b)}
        # decode: one token + a state whose cache capacity is shape.seq_len
        return {"token": _meta(b, 1, dtype=torch.int32),
                "state": self.state_specs(shape)}

    def state_specs(self, shape: ShapeSpec) -> dict:
        """The decode state on the ``meta`` device: ``prefill`` of one
        token fewer than the cell, so the cache has a free slot at
        capacity ``seq_len`` (the state's structure does not depend on the
        plan)."""
        b = shape.global_batch
        inputs = {"tokens": _meta(b, self._token_len(shape) - 1,
                                  dtype=torch.int32), **self._extra_specs(b)}
        with torch.device("meta"):
            _, state = self.prefill(self.param_shapes(), inputs, ExecPlan(),
                                    cache_capacity=shape.seq_len)
        return state

    # ------------------------------------------------------------ demo batch
    def demo_batch(self, generator: torch.Generator, batch: int, seq: int,
                   device=None) -> dict:
        """Random tokens and labels (and bf16 frames for an enc-dec model,
        bf16 patch features for a VLM) from ``generator`` (a CPU
        generator), on ``device`` (``cuda`` unless ``"cpu"`` is asked
        for)."""
        from repro_torch.core.frontends.export_frontend import resolve_device

        cfg, dev = self.cfg, resolve_device(device)
        s = seq - (cfg.vision_patches or 0)
        out = {"tokens": torch.randint(0, cfg.vocab, (batch, s),
                                       generator=generator, dtype=torch.int32),
               "labels": torch.randint(0, cfg.vocab, (batch, s),
                                       generator=generator, dtype=torch.int32)}
        if self._encdec:
            out["frames"] = torch.randn(
                batch, cfg.encoder_seq, cfg.d_model,
                generator=generator).to(torch.bfloat16)
        if cfg.vision_patches:
            out["patch_feats"] = torch.randn(
                batch, cfg.vision_patches, cfg.vision_dim,
                generator=generator).to(torch.bfloat16)
        return {k: v.to(dev) for k, v in out.items()}


def build_model(cfg: ArchConfig) -> Model:
    T.check_family(cfg)
    return Model(cfg)
