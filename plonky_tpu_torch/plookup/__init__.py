"""Plookup (ia.cr/2020/315): a proof that a multiset f lies in a table t,
over a Halo curve (reference: plookup/src/)."""
from .plookup import grand_polynomial, pad_inputs, prove, sort_by, verify
from .proof import Opening, PlookupChallenge, PlookupOpenings, PlookupProof
from .table import Table
