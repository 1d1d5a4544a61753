"""One process of a real multi-controller `so_jax --distributed` CLI run.

Launched (N times) by tests/test_distributed.py::test_distributed_cli_*:

    python distributed_cli_worker.py <port> <process_id> <num_processes> \
        <local_devices> <workdir> [extra CLI args...]

Each process joins the localhost coordinator through the standard JAX env
vars (so_jax.parallel.distributed.init_distributed reads them), runs the
IDENTICAL so_jax CLI command, and process 0 writes the outputs — the
parent compares them byte-for-byte against the single-process CLI.
"""

import os
import sys

port, pid, nproc, ldev, workdir = sys.argv[1:6]
extra = sys.argv[6:]

os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ldev}"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
os.environ["SO_JAX_SLAB"] = "0"
os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
os.environ["JAX_NUM_PROCESSES"] = nproc
os.environ["JAX_PROCESS_ID"] = pid

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from so_jax.cli import main  # noqa: E402

rc = main(["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin",
           "-o", f"{workdir}/dist", "--distributed"] + extra)
assert rc == 0, rc
print(f"DISTRIBUTED_CLI_OK pid={pid}", flush=True)
