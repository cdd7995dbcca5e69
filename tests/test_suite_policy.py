"""The suite's thread policy, set by importing ``torch_ranks``: one thread
in every BLAS, OpenMP and torch pool of a test process and of the
processes it starts."""

import json
import subprocess
import sys

import numpy  # noqa: F401 (loads its BLAS)
import scipy.linalg  # noqa: F401 (loads its own BLAS)
import sklearn.linear_model  # noqa: F401 (loads its OpenMP)
import threadpoolctl
import torch

import torch_ranks  # noqa: F401 (sets the policy)

_POOLS = """
import json, numpy, scipy.linalg, sklearn.linear_model, threadpoolctl, torch
print(json.dumps({"pools": {p["filepath"]: p["num_threads"]
                            for p in threadpoolctl.threadpool_info()},
                  "torch": torch.get_num_threads()}))
"""


def test_every_thread_pool_has_one_thread():
    pools = {p["filepath"]: p["num_threads"]
             for p in threadpoolctl.threadpool_info()}
    assert pools and set(pools.values()) == {1}, pools
    assert torch.get_num_threads() == 1


def test_a_started_process_has_one_thread_in_every_pool():
    # What the gloo ranks inherit: the environment, not the limits above.
    out = subprocess.run([sys.executable, "-c", _POOLS], check=True,
                         capture_output=True, text=True, timeout=300)
    seen = json.loads(out.stdout.splitlines()[-1])
    assert seen["pools"] and set(seen["pools"].values()) == {1}, seen
    assert seen["torch"] == 1
