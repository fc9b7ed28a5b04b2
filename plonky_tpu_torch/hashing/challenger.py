"""Fiat-Shamir transcript: duplex-sponge Challenger (host side).

Exact behavioral port of the reference Challenger (src/plonk_challenger.rs:
5-108) including its buffer mechanics: `get_challenge` first absorbs any
buffered inputs; the absorb step RESETS the output buffer to the rate part of
the state (even when no inputs were pending), and challenges are popped from
the END of the output buffer.  These quirks are part of the transcript
definition and must match for proof compatibility.

The transcript is inherently sequential and tiny (width-4 sponge), so it runs
on host python ints.
"""

from __future__ import annotations

from ..fields.spec import FieldSpec
from .rescue import (
    RESCUE_SPONGE_RATE,
    RESCUE_SPONGE_WIDTH,
    rescue_permutation_host,
)


class Challenger:
    def __init__(self, spec: FieldSpec, security_bits: int):
        self.spec = spec
        self.security_bits = security_bits
        self.sponge_state = [0] * RESCUE_SPONGE_WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def observe_element(self, element: int):
        self.output_buffer.clear()
        self.input_buffer.append(element % self.spec.p)

    def observe_elements(self, elements):
        for e in elements:
            self.observe_element(e)

    def observe_affine_point(self, point):
        """point: an AffinePoint (curves layer); observes x then y."""
        assert not point.zero
        self.observe_element(point.x)
        self.observe_element(point.y)

    def observe_affine_points(self, points):
        for pt in points:
            self.observe_affine_point(pt)

    def get_challenge(self) -> int:
        self._absorb_buffered_inputs()
        if not self.output_buffer:
            self.sponge_state = rescue_permutation_host(
                self.spec, self.sponge_state, self.security_bits)
            self.output_buffer = list(self.sponge_state[:RESCUE_SPONGE_RATE])
        return self.output_buffer.pop()

    def get_2_challenges(self):
        return self.get_challenge(), self.get_challenge()

    def get_3_challenges(self):
        return self.get_challenge(), self.get_challenge(), self.get_challenge()

    def get_n_challenges(self, n: int):
        return [self.get_challenge() for _ in range(n)]

    def _absorb_buffered_inputs(self):
        p = self.spec.p
        for i in range(0, len(self.input_buffer), RESCUE_SPONGE_RATE):
            chunk = self.input_buffer[i:i + RESCUE_SPONGE_RATE]
            for j, x in enumerate(chunk):
                self.sponge_state[j] = (self.sponge_state[j] + x) % p
            self.sponge_state = rescue_permutation_host(
                self.spec, self.sponge_state, self.security_bits)
        self.output_buffer = list(self.sponge_state[:RESCUE_SPONGE_RATE])
        self.input_buffer.clear()
