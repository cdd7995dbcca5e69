"""The port's runtime aux modules (edrgp_tpu_torch.checkpoint,
edrgp_tpu_torch.profiling, edrgp_tpu_torch.parallel.heartbeat) against the
JAX package, on the CPU: checkpoints written by either package load in the
other to the same arrays; the watchdog and heartbeat files behave as
``tests/test_heartbeat.py`` holds the JAX package's; the FLOP estimate is
the same formula.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import one_torch_thread  # noqa: F401 (autouse)
from edrgp_tpu import checkpoint as jckpt
from edrgp_tpu import profiling as jprofiling
from edrgp_tpu.inference.hmc import AdaptState as JAdaptState
from edrgp_tpu.inference.hmc import HMCState as JHMCState
from edrgp_tpu.ops.svgp import SVGPState as JSVGPState
from edrgp_tpu_torch import checkpoint, profiling
from edrgp_tpu_torch._pytree import leaves
from edrgp_tpu_torch.inference.hmc import AdaptState, HMCState
from edrgp_tpu_torch.ops.svgp import SVGPState
from edrgp_tpu_torch.parallel import checksum
from edrgp_tpu_torch.parallel.heartbeat import (StallWatchdog,
                                                read_heartbeats, stale_peers,
                                                write_heartbeat)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "kernel": {"variance": np.array(0.3),
                   "lengthscale": rng.normal(size=3)},
        "raw_noise": np.array(-1.5),
        "q": (rng.normal(size=4), rng.normal(size=(4, 4))),
        "chains": [rng.normal(size=(2, 3)), np.arange(5, dtype=np.int64)],
    }


def _torch_tree(a):
    t = {k: torch.as_tensor(v) for k, v in a["kernel"].items()}
    return {"kernel": t, "raw_noise": torch.as_tensor(a["raw_noise"]),
            "q": SVGPState(*(torch.as_tensor(v) for v in a["q"])),
            "chains": [torch.as_tensor(v) for v in a["chains"]]}


def _jax_tree(a):
    t = {k: jnp.asarray(v) for k, v in a["kernel"].items()}
    return {"kernel": t, "raw_noise": jnp.asarray(a["raw_noise"]),
            "q": JSVGPState(*(jnp.asarray(v) for v in a["q"])),
            "chains": [jnp.asarray(v) for v in a["chains"]]}


def _leaves_np(tree):
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                       else x) for x in leaves(tree)]


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    a = _arrays()
    jckpt.save_checkpoint(str(tmp_path), _jax_tree(a), 12)
    like = _torch_tree(_arrays(seed=1))
    tree, step = checkpoint.load_checkpoint(str(tmp_path), like)
    assert step == 12
    assert isinstance(tree["q"], SVGPState)
    for got, want in zip(_leaves_np(tree), _leaves_np(_torch_tree(a))):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_port_checkpoint_loads_in_jax(tmp_path):
    a = _arrays()
    path = checkpoint.save_checkpoint(str(tmp_path), _torch_tree(a), 3)
    with np.load(path) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
    tree, step = jckpt.load_checkpoint(str(tmp_path), _jax_tree(_arrays(1)))
    assert step == 3
    flat = jax.tree_util.tree_flatten_with_path(_jax_tree(a))[0]
    assert manifest["keys"] == [jax.tree_util.keystr(p) for p, _ in flat]
    assert manifest["treedef"] == str(
        jax.tree_util.tree_structure(_jax_tree(a)))
    for got, (_, want) in zip(jax.tree_util.tree_leaves(tree), flat):
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_sampler_state_round_trips_bitwise(tmp_path):
    """NUTS's HMCState and AdaptState (float32, as on the card) come back
    with the same bits, dtype and device."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float32)

    state = (HMCState(q=r(4, 3), logp=r(4), grad=r(4, 3)),
             AdaptState(*(r(4) for _ in range(5)), r(4, 3), r(4, 3),
                        r(4, 3)))
    checkpoint.save_checkpoint(str(tmp_path), state, 7)
    like = tuple(type(s)(*(torch.zeros_like(t) for t in s)) for s in state)
    back, _ = checkpoint.load_checkpoint(str(tmp_path), like)
    for s, b in zip(state, back):
        for x, y in zip(s, b):
            assert y.dtype == torch.float32 and torch.equal(x, y)
    jtree, _ = jckpt.load_checkpoint(str(tmp_path), (
        JHMCState(*(jnp.zeros(t.shape, jnp.float32) for t in state[0])),
        JAdaptState(*(jnp.zeros(t.shape, jnp.float32) for t in state[1]))))
    assert np.array_equal(np.asarray(jtree[1].inv_mass),
                          state[1].inv_mass.numpy())


def test_manager_keeps_the_last_k(tmp_path):
    d = str(tmp_path / "ckpts")
    mgr = checkpoint.CheckpointManager(d, max_to_keep=2, save_every=5)
    tree = _torch_tree(_arrays())
    for step in range(26):
        mgr.maybe_save(tree, step)
    assert checkpoint.latest_step(d) == 25
    assert sorted(os.listdir(d)) == ["ckpt_20.npz", "ckpt_25.npz"]
    _, step = mgr.restore_or(tree)
    assert step == 25
    fresh = checkpoint.CheckpointManager(str(tmp_path / "none"))
    assert fresh.restore_or(tree, default_step=7)[1] == 7


def test_structure_mismatch_raises(tmp_path):
    checkpoint.save_checkpoint(str(tmp_path), _torch_tree(_arrays()), 0)
    with pytest.raises(ValueError):
        checkpoint.load_checkpoint(str(tmp_path), {"only": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path / "none"), {})


def test_checksum_is_the_jax_formula():
    from edrgp_tpu.parallel.distributed import checksum as jchecksum
    a = _arrays()
    assert checksum(_torch_tree(a)) == jchecksum(_jax_tree(a))


def test_watchdog_fires_on_stall():
    fired = threading.Event()
    seen = {}

    def on_stall(silent, step):
        seen["silent"], seen["step"] = silent, step
        fired.set()

    with StallWatchdog(timeout_s=0.2, poll_s=0.05, on_stall=on_stall) as dog:
        dog.beat(7)
        assert fired.wait(timeout=2.0)
    assert dog.fired
    assert seen["step"] == 7
    assert seen["silent"] >= 0.2


def test_watchdog_quiet_while_beating():
    with StallWatchdog(timeout_s=0.4, poll_s=0.05) as dog:
        for step in range(8):
            time.sleep(0.05)
            dog.beat(step)
    assert not dog.fired


def test_watchdog_stop_idempotent():
    dog = StallWatchdog(timeout_s=10.0).start()
    dog.stop()
    dog.stop()
    assert not dog.fired


def test_heartbeat_files_roundtrip(tmp_path):
    d = str(tmp_path / "hb")
    write_heartbeat(d, 0, step=12)
    write_heartbeat(d, 1, step=12, payload={"elbo": -3.5})
    recs = read_heartbeats(d)
    assert set(recs) == {0, 1}
    assert recs[1]["elbo"] == -3.5
    assert stale_peers(d, timeout_s=60.0, expected=2) == []


def test_stale_peer_detection(tmp_path):
    d = str(tmp_path / "hb")
    now = time.time()
    write_heartbeat(d, 0, step=5)
    write_heartbeat(d, 1, step=2)
    path = os.path.join(d, "heartbeat-00001.json")
    with open(path) as f:
        rec = json.load(f)
    rec["time"] = now - 100.0
    with open(path, "w") as f:
        json.dump(rec, f)
    assert stale_peers(d, timeout_s=30.0, now=now) == [1]
    assert stale_peers(d, timeout_s=30.0, expected=3, now=now) == [1, 2]


def test_torn_heartbeat_ignored(tmp_path):
    d = str(tmp_path / "hb")
    write_heartbeat(d, 0)
    with open(os.path.join(d, "heartbeat-00009.json"), "w") as f:
        f.write('{"process_id": 9, "ti')
    assert set(read_heartbeats(d)) == {0}


def test_flops_estimate_matches_jax():
    for n, q in ((10, 2), (1000, 8), (10_000, 10)):
        assert (profiling.flops_estimate_nlml(n, q)
                == jprofiling.flops_estimate_nlml(n, q))


def test_trace_and_timing(tmp_path):
    x = torch.randn(64, 64, dtype=torch.float64)
    with profiling.trace(str(tmp_path)):
        (x @ x).sum()
    with open(tmp_path / "trace.json") as f:
        assert "aten::mm" in f.read()
    t = profiling.time_compiled(lambda a: a @ a, x, iters=3)
    assert set(t) == {"compile_s", "mean_s", "per_s"} and t["mean_s"] > 0


def test_trace_counts_launches_against_kernels():
    """What ``trace`` checks a CUDA trace by: runtime and driver launches
    against kernels on the card, copies and fills not counted."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def ev(name, device=DeviceType.CPU):
        return SimpleNamespace(name=name, device_type=device)

    events = [ev("aten::mm"), ev("cudaLaunchKernel"),
              ev("cudaLaunchKernelExC"), ev("cuLaunchKernelEx"),
              ev("cudaMemcpyAsync"), ev("kmat_kernel", DeviceType.CUDA),
              ev("Memcpy DtoH (Device -> Pageable)", DeviceType.CUDA),
              ev("Memset (Device)", DeviceType.CUDA)]
    assert profiling._launches_and_kernels(events) == (3, 1)
    assert profiling._launches_and_kernels(events[:2]) == (1, 0)
