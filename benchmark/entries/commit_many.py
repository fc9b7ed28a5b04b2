"""The prover's wire commitments: CommitmentEngine.commit_many over the
configuration's basis, one multi-MSM of `wires` polynomials and the
readback of their affine points.

Check: every sampled call's commitments against e_k G, e_k worked out by
discrete logs from the seed's chain basis (reference/msm.py).  The
control is that reference with each scalar cut below its top window."""

from __future__ import annotations

import torch

from benchmark import costs, inputs
from benchmark.reference import curve as rcurve
from benchmark.reference import msm as rmsm


class Runner:
    def __init__(self, ctx):
        from plonky_tpu_torch.curves import instances
        from plonky_tpu_torch.protocol.circuit import CommitmentEngine

        cfg = ctx.config
        self.ctx = ctx
        self.curve = getattr(instances, cfg["curve"]["port"])
        self.ref = rcurve.Curve.of(cfg)
        self.n = 1 << cfg["degree_log2"]
        self.k = cfg["wires"]
        self.c = cfg["commit_window_bits"]
        self.a = inputs.rng(ctx.seed, "basis").randrange(1, self.ref.r)
        engine = CommitmentEngine.__new__(CommitmentEngine)
        engine.curve, engine.h, engine.n = self.curve, None, self.n
        engine.g_dev = inputs.chain_basis(self.curve, self.ref, self.n, self.a, ctx.device)
        self.engine = engine
        self.rates = {"msm_points_per_s": self.k * self.n}

    def inputs(self, j: int) -> torch.Tensor:
        cfg = self.ctx.config["curve"]
        return inputs.random_field((self.k, self.n), cfg["scalar_limbs"], self.ref.r,
                                   inputs.derived_seed(self.ctx.seed, "call", j),
                                   self.ctx.device)

    def call(self, coeffs: torch.Tensor) -> list:
        with self.ctx.span("protocol.commit_many"):
            out = self.engine.commit_many(coeffs, blinding=False)
        return [None if c.commitment.zero else (c.commitment.x, c.commitment.y)
                for c in out]

    def release(self) -> None:
        self.engine = None

    def least(self, coeffs: torch.Tensor) -> tuple:
        return costs.msm_work(coeffs, self.ref.r.bit_length(), self.c, self.n,
                              self.ref.p, self.ctx.config["curve"]["base_limbs"])

    def check(self, samples: list, control: bool) -> dict:
        return {"wrong_points": [rmsm.wrong_points(self.ref, self.a, inputs.CHAIN_POINTS,
                                                   self.c, samples, control), 0]}
