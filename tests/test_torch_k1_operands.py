"""K1's elementwise operands read in place (fields/ops.py: operand_layout,
layout_reads, _launch_binary; csrc/field_kernels.cu: field_binary_kernel),
on the CPU.

The layout of every operand a prove hands add, sub and mul (a contiguous
tensor, a [L, 9, N] slice, a rolled tensor's slice, an [L, 1] column on
either side, a [L, 1, n] operand against [L, B, n], the IPA's 2-D halves,
one tensor as both operands, a view 1-3 elements off its storage's start,
a ragged N, N = 1), at 8 and 12 limbs: gathered from the storage by its
offset and strides it equals the broadcast view; a Python model of the
kernel's indexing (one element a thread, the ragged last block) computes
every output element exactly once from reads inside the storage, and through the wrapper (its launch stubbed by that model) gives
the plain version's result; the refusals (a negative stride, a read past
the storage).  Last, the plain add, sub and mul on those views
against the JAX package's on the same values (tests/fixtures/jax_k1.json,
made again through interop by the slow test beside it), exactly.
"""

import ctypes

import numpy as np
import pytest
import torch

import _jax_fixtures as jaxfx
from plonky_tpu_torch import _cuda
from plonky_tpu_torch.fields import (BLS12_377_BASE, TWEEDLEDEE_BASE,
                                     TWEEDLEDUM_BASE)
from plonky_tpu_torch.fields import ops as fops

torch.set_num_threads(1)

FIELDS = (TWEEDLEDEE_BASE, TWEEDLEDUM_BASE, BLS12_377_BASE)
N, ROWS, B = 64, 9, 3
OPS = {"field_add": fops.add_plain, "field_sub": fops.sub_plain,
       "field_mul": fops.mul_plain}


def _canonical(spec, shape, seed):
    """Canonical values [L, *shape] from a numpy seed, 0, 1 and p - 1 first."""
    rng = np.random.default_rng(seed)
    count = int(np.prod(shape))
    width = 4 * spec.limbs + 8
    vals = [0, 1, spec.p - 1] + [int.from_bytes(rng.bytes(width), "little") % spec.p
                                 for _ in range(count)]
    return fops.from_ints(spec, vals[:count], "cpu").reshape(spec.limbs, *shape)


CASES = ("contiguous", "slices", "rolled slice", "column left", "column right",
         "broadcast", "halves", "same", "offset", "ragged", "one", "three levels")


def layout_cases(spec, seed=1):
    """(name, a, b): the operand layouts of a prove's add, sub and mul,
    built from real tensors."""
    base = _canonical(spec, (ROWS, N), seed)
    rolled = torch.roll(base, -8, dims=-1)
    col = _canonical(spec, (1,), seed + 1)
    flat = base.reshape(spec.limbs, -1)
    same = base[:, 6]
    cases = [
        ("contiguous", base[:, 0].contiguous(), base[:, 1].contiguous()),
        ("slices", base[:, 3], base[:, 5]),
        ("rolled slice", rolled[:, 2], base[:, 2]),
        ("column left", col, base[:, 4]),
        ("column right", base[:, 4], col),
        ("broadcast", base[:, :1], base[:, 2:2 + B]),
        ("halves", base[:, :, :N // 2], base[:, :, N // 2:]),
        ("same", same, same),
        ("offset", flat[:, 1:1 + N], flat[:, 3:3 + N]),
        ("ragged", base[:, 7, :N - 3], base[:, 8, 3:]),
        ("one", base[:, 0, 5], col),
        ("three levels", base[:, ::2, :N // 2][:, :, None].expand(
            spec.limbs, ROWS // 2 + 1, 2, N // 2), base[:, :1, :N // 2][:, None]),
    ]
    assert tuple(c[0] for c in cases) == CASES
    return cases


def _storage(x):
    """x's whole storage as a flat int32 tensor, and x's first element's
    offset in it."""
    whole = x.untyped_storage().nbytes() // x.element_size()
    return torch.as_strided(x, (whole,), (1,), 0), x.storage_offset()


# Threads a block of the elementwise launch (csrc/field_kernels.cu:
# K1_THREADS); the model's coverage holds at any.
THREADS = 128


def operand_offset(o, i, n):
    """csrc/field_kernels.cu:load_strided's element offset; o = (base, limb,
    outer, inner, inner_n)."""
    _base, _limb, outer, inner, inner_n = o
    if inner_n >= n:
        return i * inner
    q = i // inner_n
    return q * outer + (i - q * inner_n) * inner


def kernel_walk(n, threads):
    """The element of each thread of launch_binary's grid, None past the
    tail: ceil(n / threads) blocks, thread t of block b on element
    b threads + t."""
    for blk in range(-(-n // threads)):
        for t in range(threads):
            e = blk * threads + t
            yield e if e < n else None


def model_launch(operands, n, nl):
    """Runs the kernel's reads over the operands' storage: each output
    element computed once, every read inside the storage.  Returns the
    operands gathered as [L, n]."""
    seen = [e for e in kernel_walk(n, THREADS) if e is not None]
    assert sorted(seen) == list(range(n))
    gathered = []
    for x, o in operands:
        flat, start = _storage(x)
        base = start + (o[0] - x.data_ptr()) // 4
        off = np.array([operand_offset(o, e, n) for e in range(n)])
        idx = base + np.arange(nl)[:, None] * o[1] + off
        assert idx.min() >= 0 and idx.max() < flat.numel()
        gathered.append(flat[torch.from_numpy(idx)])
    return gathered


@pytest.mark.parametrize("spec", [TWEEDLEDEE_BASE, BLS12_377_BASE],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("case", CASES)
def test_layout_gathers_the_view(spec, case):
    """operand_layout's two levels, read from the storage by the offset
    and strides, give the broadcast view's elements; the three-level
    view alone has no layout (the wrapper copies it)."""
    name, a, b = next(c for c in layout_cases(spec) if c[0] == case)
    batch = fops.batch_shape(a, b)
    n = int(np.prod(batch)) if batch else 1
    for x in (a, b):
        view = fops._expand(x, batch)
        layout = fops.operand_layout(view.shape[1:], view.stride()[1:])
        if name == "three levels" and x is a:
            assert layout is None
            view = view.contiguous()
            layout = fops.operand_layout(view.shape[1:], view.stride()[1:])
        assert layout is not None
        outer, inner, inner_n = layout
        assert n % inner_n == 0
        flat, start = _storage(view)
        i = torch.arange(n)
        off = (i // inner_n) * outer + (i % inner_n) * inner
        got = flat[start + torch.arange(spec.limbs)[:, None] * view.stride(0) + off]
        assert torch.equal(got, view.reshape(spec.limbs, n))
        assert start + fops.layout_reads(view, layout, n) < flat.numel()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 64, 125, 576 + 1, 1024])
@pytest.mark.parametrize("threads", [1, 32, 128])
def test_kernel_walk_covers_each_element_once(n, threads):
    """Every element exactly once, the threads past the tail idle, one
    block for N = 1."""
    walked = list(kernel_walk(n, threads))
    assert sorted(e for e in walked if e is not None) == list(range(n))
    assert len(walked) - n < threads
    if n == 1:
        assert walked == [0] + [None] * (threads - 1)


def _stub_launch(monkeypatch, calls):
    """_cuda.launch replaced by the kernel model over the host words (the
    device checks skipped, the storage check kept)."""
    def check(name, t, rows=None, reads=None):
        assert t.dtype == torch.int32 and (rows is None or t.shape[0] == rows)
        if reads is None:
            assert t.is_contiguous()
        else:
            _cuda.check_reads(name, t, reads)

    def launch(name, entry, tensors, out_ptr, words_ptr, n, consts):
        out, *views = tensors
        assert out_ptr == out.data_ptr() and out.is_contiguous()
        words = np.ctypeslib.as_array((ctypes.c_int64 * 10).from_address(words_ptr))
        operands = [(x, tuple(int(w) for w in words[5 * k:5 * k + 5]))
                    for k, x in enumerate(views)]
        nl = out.shape[0]
        gathered = model_launch(operands, n, nl)
        spec = next(f for f in FIELDS if f.mul_consts.ctypes.data == consts)
        assert spec.limbs == nl
        kernel = name.removesuffix("_l12")
        out.reshape(nl, n).copy_(OPS[kernel](spec, *gathered))
        calls.append(name)
    monkeypatch.setattr(fops, "_dispatch", lambda t: True)
    monkeypatch.setattr(_cuda, "check", check)
    monkeypatch.setattr(_cuda, "launch", launch)


@pytest.mark.parametrize("spec", [TWEEDLEDEE_BASE, BLS12_377_BASE],
                         ids=lambda s: s.name)
def test_wrapper_reads_in_place(monkeypatch, spec):
    """add, sub and mul through _launch_binary, the launch run by the
    kernel model over the words it is given: the plain version's result
    on every layout, one launch a call, and a copy (counted in
    _cuda.COPIES) for the three-level view alone."""
    cases = layout_cases(spec)
    want = {(name, k): fn(spec, a, b) for name, a, b in cases
            for k, fn in OPS.items()}
    calls = []
    _stub_launch(monkeypatch, calls)
    _cuda.reset_launches()
    for name, a, b in cases:
        for k, fn in (("field_add", fops.add), ("field_sub", fops.sub),
                      ("field_mul", fops.mul)):
            got = fn(spec, a, b)
            assert torch.equal(got, want[(name, k)]), (name, k)
            assert calls.pop() == _cuda.width_name(k, spec.limbs) and not calls
    copies = {k: v for k, v in _cuda.COPIES.items() if v}
    assert copies == {_cuda.width_name(k, spec.limbs): 1 for k in OPS}
    _cuda.reset_launches()
    assert not any(_cuda.COPIES.values())


def test_refusals():
    """A negative stride raises; so does a read past the storage, and the
    wrapper checks the last element it reads."""
    with pytest.raises(ValueError, match="negative stride"):
        fops.operand_layout((4, 8), (-8, 1))
    x = torch.zeros((8, 9, 16), dtype=torch.int32)
    view = x[:, 8]
    layout = fops.operand_layout(view.shape[1:], view.stride()[1:])
    _cuda.check_reads("field_add", view, fops.layout_reads(view, layout, 16))
    with pytest.raises(ValueError, match="past the tensor's storage"):
        _cuda.check_reads("field_add", view, fops.layout_reads(view, (0, 1, 17), 17))
    with pytest.raises(ValueError, match="past the tensor's storage"):
        _cuda.check_reads("field_add", view, -1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.check("field_add", view, 8, reads=0)


def _port_results(spec) -> dict:
    """sha256 of the plain add, sub and mul over every layout case (the
    results' canonical ints, row-major, case after case)."""
    out = {}
    for k, fn in OPS.items():
        vals = []
        for _name, a, b in layout_cases(spec):
            vals += list(np.asarray(fops.to_ints(spec, fn(spec, a, b))).reshape(-1))
        out[k] = jaxfx.digest(vals)
    return out


def _jax_results(spec) -> dict:
    """The same through the JAX package on the same values (the views'
    elements, broadcast), read back through interop."""
    import jax

    from plonky_tpu import fields as jfields
    from plonky_tpu.fields import ops as jfops
    from plonky_tpu_torch import interop
    jspec = {TWEEDLEDEE_BASE.name: jfields.TWEEDLEDEE_BASE,
             TWEEDLEDUM_BASE.name: jfields.TWEEDLEDUM_BASE,
             BLS12_377_BASE.name: jfields.BLS12_377_BASE}[spec.name]
    a_vals, b_vals = [], []
    for _name, a, b in layout_cases(spec):
        batch = fops.batch_shape(a, b)
        for x, vals in ((a, a_vals), (b, b_vals)):
            vals += list(np.asarray(fops.to_ints(
                spec, fops._expand(x, batch).reshape(spec.limbs, -1))).reshape(-1))
    ops = jax.jit(lambda x, y: (jfops.add(jspec, x, y), jfops.sub(jspec, x, y),
                                jfops.mul(jspec, x, y)))(
        jfops.from_ints(jspec, a_vals), jfops.from_ints(jspec, b_vals))
    return {k: jaxfx.digest(np.asarray(fops.to_ints(spec, interop.field_from_jax_digits(
        spec, np.asarray(r), "cpu"))).reshape(-1)) for k, r in zip(OPS, ops)}


@pytest.mark.parametrize("spec", FIELDS, ids=lambda s: s.name)
def test_plain_ops_on_views_match_jax(spec):
    """The plain add, sub and mul on every layout case, exactly equal to
    the JAX package's on the same values (tests/fixtures/jax_k1.json)."""
    assert _port_results(spec) == jaxfx.load("k1", f"ops {spec.name}")


@pytest.mark.slow
@pytest.mark.parametrize("spec", FIELDS, ids=lambda s: s.name)
def test_jax_k1_fixture(spec):
    jaxfx.check("k1", f"ops {spec.name}", _jax_results(spec))
