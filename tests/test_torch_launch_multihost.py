"""``python -m repro_torch.launch.train --coordinator``: two hosts.

Two ``--device cpu`` processes join one gloo group through
``--coordinator localhost:<port>`` (``--num-hosts 2``, ``--host-id`` 0
and 1), each trains a reduced gemma2-2b for 2 steps as the single host
does, and leaves the group; both print the single-host run's losses
(step 0's on the log, the last on stdout), as the JAX package's
launcher does after ``jax.distributed.initialize``.
"""
import os
import re
import subprocess
import sys

from repro_torch.launch.mesh import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--steps",
        "2", "--batch", "2", "--seq", "16"]


def _start(extra):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _losses(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    first = re.findall(r"step 0 loss (\S+)", err)
    last = re.findall(r"done: step 1 loss (\S+)", out)
    assert len(first) == len(last) == 1, (out, err[-2000:])
    return first[0], last[0]


def test_two_hosts_train_with_the_single_hosts_losses():
    coord = f"localhost:{_free_port()}"
    hosts = [_start(["--coordinator", coord, "--num-hosts", "2",
                     "--host-id", str(i)]) for i in range(2)]
    single = _start([])
    try:
        want = _losses(single)
        for proc in hosts:
            assert _losses(proc) == want
    finally:
        for proc in hosts + [single]:
            proc.kill()
