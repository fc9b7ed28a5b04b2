"""Two processes on torch.distributed (gloo), each with 4 CPU entries: the
port of tests/test_distributed.py.  Each process runs
tests/_torch_distributed_worker.py, which checks a sum over the hybrid
[2, 4] mesh, the MSM of both processes' shares against a host oracle and
the domain-sharded FFT across both processes against the one-process
`fft` (exact: canonical values and affine points)."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed():
    port = _free_port()
    worker = os.path.join(REPO, "tests", "_torch_distributed_worker.py")
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": "0",
                    "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
        procs.append(subprocess.Popen(
            [sys.executable, worker], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert "sharded FFT OK" in out, out[-3000:]
