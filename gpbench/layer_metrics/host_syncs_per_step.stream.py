"""Calls in the traced window at which the host waited for the device, over
the SVGP steps taken in it (layer: host reads): the CUDA runtime's
``cudaStreamSynchronize`` (PyTorch's reads of a device value, as the jitter
ladder's status), ``cudaEventSynchronize`` and ``cudaDeviceSynchronize``,
and each synchronous ``cudaMemcpy`` whose copy ran device to host (told by
the device record it launched)."""

SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize")


def read(rec):
    steps = getattr(rec.probe, "steps", 0)
    if not steps or not rec.device_ops:
        return None
    t0, t1 = rec.t0_ns, rec.t1_ns
    inside = [(n, s) for n, s, _ in rec.host_events if t0 <= s < t1]
    copies = {s for n, s in inside if n == "cudaMemcpy"}
    syncs = sum(1 for n, _ in inside if n in SYNCS)
    syncs += sum(1 for name, _, _, launch in rec.device_ops
                 if "DtoH" in name and launch in copies)
    return syncs / steps
