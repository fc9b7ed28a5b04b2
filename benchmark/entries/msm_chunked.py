"""BLS12-377 G1's MSM: msm_chunked over the configuration's basis at its
window and slice size, the result made affine on the card (K1's Fermat
inverse) and read back.

Check: every sampled call's point against e G, e worked out by discrete
logs from the seed's chain basis (reference/msm.py).  The control is that
reference with each scalar cut below its top window."""

from __future__ import annotations

import torch

from benchmark import costs, inputs
from benchmark.reference import curve as rcurve
from benchmark.reference import field as rfield
from benchmark.reference import msm as rmsm


class Runner:
    def __init__(self, ctx):
        from plonky_tpu_torch.curves import instances

        cfg = ctx.config
        self.ctx = ctx
        self.curve = getattr(instances, cfg["curve"]["port"])
        self.ref = rcurve.Curve.of(cfg)
        self.n = 1 << cfg["log_points"]
        self.c = cfg["window_bits"]
        self.chunk_log = cfg["chunk_log"]
        self.a = inputs.rng(ctx.seed, "basis").randrange(1, self.ref.r)
        self.basis = inputs.chain_basis(self.curve, self.ref, self.n, self.a, ctx.device)
        self.rates = {"msm_points_per_s": self.n}

    def inputs(self, j: int) -> torch.Tensor:
        return inputs.random_field((1, self.n), self.ctx.config["curve"]["scalar_limbs"],
                                   self.ref.r, inputs.derived_seed(self.ctx.seed, "call", j),
                                   self.ctx.device)

    def call(self, scalars: torch.Tensor) -> list:
        from plonky_tpu_torch.curves import msm as cmsm
        from plonky_tpu_torch.curves import ops as cops

        span = self.ctx.span
        with span("msm.msm_chunked"):
            pt = cmsm.msm_chunked(self.curve, self.basis, scalars, self.c, self.chunk_log)
        with span("kernels.to_affine"):
            x, y, zero = cops.to_affine(self.curve, pt)
        with span("readback"):
            xy = torch.cat([x, y], 1).cpu()
            inf = zero.reshape(-1).cpu()
        xs, ys = rfield.ints_from_limbs(xy[:, :1]), rfield.ints_from_limbs(xy[:, 1:])
        return [None if bool(z) else (u, v) for u, v, z in zip(xs, ys, inf.tolist())]

    def release(self) -> None:
        self.basis = None

    def least(self, scalars: torch.Tensor) -> tuple:
        nl = self.ctx.config["curve"]["base_limbs"]
        msm = costs.msm_work(scalars, self.ref.r.bit_length(), self.c, 1 << self.chunk_log,
                             self.ref.p, nl)
        inv = costs.inverse_work(self.ref.p, nl, 1)
        return msm[0] + inv[0], msm[1] + inv[1]

    def check(self, samples: list, control: bool) -> dict:
        return {"wrong_points": [rmsm.wrong_points(self.ref, self.a, inputs.CHAIN_POINTS,
                                                   self.c, samples, control), 0]}
