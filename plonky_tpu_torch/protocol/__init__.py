from .circuit import Circuit, CommitmentEngine, build_circuit, pedersen_bases
from .proof import OldProof, OpeningSet, Proof, ProofChallenge, SchnorrProof
from .prover import generate_proof
from .verifier import VerificationError, VerificationKey, verify_proof
from . import halo, plonk_util
