"""The prover's wire LDEs: ifft over the degree-n subgroup, then lde to
the 8n domain (poly/fft.py), a synchronize ending each call.

Check: for every sampled call, the coefficients are the inverse transform
of the values and the 8n evaluations the transform of the coefficients,
each judged whole by a random evaluation (reference/ntt.py), and every
output element is canonical.  The control is the program's outputs left
unreduced (x + p), as a transform whose last reduction is skipped leaves
them."""

from __future__ import annotations

import torch

from benchmark import costs, inputs
from benchmark.reference import field as rfield
from benchmark.reference import ntt as rntt


class Runner:
    def __init__(self, ctx):
        from plonky_tpu_torch.fields import instances
        from plonky_tpu_torch.poly import fft

        cfg = ctx.config
        sf = cfg["scalar_field"]
        self.ctx = ctx
        self.p, self.limbs = int(sf["p"], 0), sf["limbs"]
        self.lg = cfg["degree_log2"]
        self.lg8 = self.lg + (cfg["lde_factor"].bit_length() - 1)
        self.k = cfg["wires"]
        spec = getattr(instances, sf["port"])
        self.fft_n = fft.FftPrecomputation(spec, 1 << self.lg)
        self.fft_8n = fft.FftPrecomputation(spec, 1 << self.lg8)
        self.rates = {"ntt_butterflies_per_s":
                      self.k * ((self.lg << self.lg) + (self.lg8 << self.lg8)) // 2}

    def inputs(self, j: int) -> torch.Tensor:
        return inputs.random_field((self.k, 1 << self.lg), self.limbs, self.p,
                                   inputs.derived_seed(self.ctx.seed, "call", j),
                                   self.ctx.device)

    def call(self, values: torch.Tensor) -> tuple:
        from plonky_tpu_torch.poly import fft

        span = self.ctx.span
        with span("poly.ifft"):
            coeffs = fft.ifft(self.fft_n, values)
        with span("poly.lde"):
            evals = fft.lde(self.fft_8n, coeffs)
        with span("sync"):
            if evals.device.type == "cuda":
                torch.cuda.synchronize(evals.device)
        return coeffs, evals

    def release(self) -> None:
        self.fft_n = self.fft_8n = None

    def least(self, values: torch.Tensor) -> tuple:
        ifft = costs.ntt_work(self.k, self.lg, True, False, self.p, self.limbs)
        lde = costs.ntt_work(self.k, self.lg8, False, False, self.p, self.limbs)
        return ifft[0] + lde[0], ifft[1] + lde[1]

    def check(self, samples: list, control: bool) -> dict:
        sf = self.ctx.config["scalar_field"]
        rng = inputs.rng(self.ctx.seed, "check")
        dev = samples[0][1].device if samples else "cpu"
        roots = [rfield.root_of_unity(self.p, sf["generator"], sf["two_adicity"], lg)
                 for lg in (self.lg, self.lg8)]
        n, n8 = 1 << self.lg, 1 << self.lg8
        inverse = rntt.TransformCheck(self.p, rng.randrange(2, self.p), roots[0], n, n, dev)
        forward = rntt.TransformCheck(self.p, rng.randrange(2, self.p), roots[1], n8, n, dev)
        wrong = noncanonical = 0
        for _j, values, (coeffs, evals) in samples:
            if control:
                coeffs, evals = rfield.plus_p(coeffs, self.p), rfield.plus_p(evals, self.p)
            wrong += inverse.mismatches(coeffs, values) + forward.mismatches(coeffs, evals)
            noncanonical += sum(int((~rfield.below(t, self.p)).sum()) for t in (coeffs, evals))
        return {"wrong_sums": [wrong, 0], "noncanonical": [noncanonical, 0]}
