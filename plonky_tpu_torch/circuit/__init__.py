from .target import (
    GRID_WIDTH,
    NUM_ADVICE_WIRES,
    NUM_CONSTANTS,
    NUM_ROUTED_WIRES,
    NUM_WIRES,
    QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER,
    SECURITY_BITS,
    BoundedTarget,
    PublicInput,
    VirtualTarget,
    Wire,
)
from .witness import LambdaGenerator, PartialWitness, Witness, WitnessGenerator
from .partition import TargetPartitions, WirePartitions, get_subgroup_shift
from .builder import CircuitBuilder
from .gates import (
    ALL_GATES,
    ArithmeticGate,
    Base4SumGate,
    BufferGate,
    ConstantGate,
    CurveAddGate,
    CurveDblGate,
    CurveEndoGate,
    GateCtx,
    PublicInputGate,
    RescueStepAGate,
    RescueStepBGate,
    evaluate_all_constraints,
)
from .algebra import BatchAlgebra, BuilderAlgebra, HostAlgebra
