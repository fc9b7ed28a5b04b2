"""MSM scaling harness of the port (the JAX package's bin/msms_bench.py;
reference: src/bin/msms.rs, which sweeps rayon's thread pool).

Sweeps the mesh size of the point-sharded MSM (parallel/msm.py) on one
Tweedledee MSM of 2^log_n points (a tiled doubling chain, random
canonical scalars) and prints, for each mesh size, ms a call, points/s
and weak-scaling efficiency; every result is held against the
single-device `msm` (affine).  Meshes span the visible cards, or with
--virtual N hold N entries of one device (virtual shards run one after
another on their card: they measure the sharded path's overhead, not its
scaling).  The device is the card unless --device cpu is given; without a
card the default raises.

    python -m plonky_tpu_torch.msms_bench [--log-n 14] [--window 8]
        [--devices 1 2 4 8] [--reps 3] [--virtual N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .curves import TWEEDLEDEE as CURVE
from .curves import host as chost
from .curves import msm as cmsm
from .curves import ops as cops
from .device import resolve
from .fields import ops as fops
from .parallel import default_mesh, msm_sharded, shard_basis


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _affine(pt):
    x, y, zero = cops.to_affine(CURVE, pt)
    return bool(zero), fops.to_ints(CURVE.base, x), fops.to_ints(CURVE.base, y)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=14)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="mesh sizes to sweep")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--virtual", type=int, default=0, metavar="N",
                    help="meshes of up to N entries of the one device")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:<i> or cpu")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")
    dev = resolve(args.device)
    one_device = bool(args.virtual) or dev.type == "cpu"
    available = args.virtual or (torch.cuda.device_count()
                                 if dev.type == "cuda" else 1)
    sweep = args.devices or sorted({d for d in (1, 2, 4, 8, available)
                                    if d <= available})
    names = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else ["cpu"])
    n = 1 << args.log_n
    print(f"devices: {names}; mesh entries available: {available}"
          f"{' (virtual, on ' + str(dev) + ')' if args.virtual else ''}; "
          f"MSM size 2^{args.log_n}, window {args.window}", flush=True)

    rng = np.random.default_rng(0)
    chain = min(n, 1 << 10)
    cur = chost.mul(chost.generator(CURVE), int(rng.integers(1, 1 << 62)))
    pts = []
    for _ in range(chain):
        pts.append(cur)
        cur = chost.add(cur, cur)
    xs = fops.from_ints(CURVE.base, [p.x for p in pts], dev).repeat(1, n // chain)
    ys = fops.from_ints(CURVE.base, [p.y for p in pts], dev).repeat(1, n // chain)
    basis = cmsm.precompute_base(CURVE, cops.from_affine(CURVE, xs, ys))
    scalars = fops.from_ints(CURVE.scalar, [
        int.from_bytes(rng.bytes(40), "little") % CURVE.scalar.p
        for _ in range(n)], dev)
    want = _affine(cmsm.msm(CURVE, basis, scalars, args.window))

    results, base_rate = {}, None
    for nd in sweep:
        mesh = default_mesh(nd, dev) if one_device else default_mesh(nd)
        shards = shard_basis(mesh, basis)

        def run():
            return msm_sharded(mesh, CURVE, shards, scalars, args.window)
        if _affine(run()) != want:
            raise AssertionError(f"mesh={nd}: not the single-device MSM")
        _sync(mesh.cards())
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = run()
        _sync(mesh.cards())
        dt = (time.perf_counter() - t0) / args.reps
        if _affine(out) != want:
            raise AssertionError(f"mesh={nd} (timed): not the single-device MSM")
        rate = n / dt
        if base_rate is None:
            base_rate = rate
        results[nd] = {"ms": dt * 1e3, "points_per_s": rate,
                       "efficiency": rate / (base_rate * nd / sweep[0])}
        print(f"  mesh={nd:3d}: {dt * 1e3:9.2f} ms  {rate:.3e} points/s  "
              f"weak-scaling efficiency {results[nd]['efficiency'] * 100:5.1f}%",
              flush=True)
    print("every mesh size agrees with the single-device MSM", flush=True)
    return results


if __name__ == "__main__":
    main()
