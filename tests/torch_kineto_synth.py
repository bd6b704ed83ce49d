"""Synthetic ``torch.profiler`` (Kineto) Chrome traces for the tests of
``dlaf_tpu_torch/obs/devtrace.py`` and ``obs/critpath.py``.

A :class:`Trace` holds the events of one process on one host thread and
its CUDA devices, in the shapes Kineto writes them: ``user_annotation``
ranges on the host thread with their ``gpu_user_annotation`` mirrors on
the device track, ``cpu_op`` events around ``cuda_runtime`` launches that
carry ``args.correlation``, the launched ``kernel``/``gpu_memcpy``/
``gpu_memset`` events with the same correlation, and the ``ac2g`` flow
pair between the two.
"""

import numpy as np

HOST_PID, HOST_TID = 4242, 4242


class Trace:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.corr = 1000
        self.events = [
            {"ph": "M", "name": "process_name", "pid": HOST_PID, "tid": 0,
             "args": {"name": "python"}},
            {"ph": "M", "name": "thread_name", "pid": HOST_PID, "tid": HOST_TID,
             "args": {"name": "thread 4242 (python)"}},
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python"}},
            {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        ]

    def range(self, name: str, ts: float, dur: float, mirror_lag: float = 3.0,
              tid: int = HOST_TID):
        """A ``record_function`` range and its device-side mirror."""
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name, "pid": HOST_PID,
                            "tid": tid, "ts": float(ts), "dur": float(dur),
                            "args": {"External id": self.corr}})
        self.events.append({"ph": "X", "cat": "gpu_user_annotation", "name": name, "pid": 0,
                            "tid": 7, "ts": float(ts) + mirror_lag, "dur": float(dur),
                            "args": {"External id": self.corr}})
        return self

    def launch(self, ts: float, name: str, start: float, dur: float, cat: str = "kernel",
               device: int = 0, stream: int = 7, correlation: bool = True, flow: bool = True,
               tid: int = HOST_TID):
        """An op launched at host time ``ts`` that runs on the device over
        ``[start, start + dur]``; returns its correlation id."""
        self.corr += 1
        c = self.corr
        api = {"kernel": "cudaLaunchKernel", "gpu_memcpy": "cudaMemcpyAsync",
               "gpu_memset": "cudaMemsetAsync"}[cat]
        self.events.append({"ph": "X", "cat": "cpu_op", "name": "aten::op", "pid": HOST_PID,
                            "tid": tid, "ts": float(ts) - 1.0, "dur": 4.0, "args": {}})
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": api, "pid": HOST_PID,
                            "tid": tid, "ts": float(ts), "dur": 2.0,
                            "args": {"cbid": 211, "correlation": c}})
        args = {"device": device, "stream": stream, "context": 1}
        if correlation:
            args["correlation"] = c
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": device, "tid": stream,
                            "ts": float(start), "dur": float(dur), "args": args})
        if flow:
            self.events.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": c,
                                "pid": HOST_PID, "tid": tid, "ts": float(ts)})
            self.events.append({"ph": "f", "cat": "ac2g", "name": "ac2g", "id": c, "bp": "e",
                                "pid": device, "tid": stream, "ts": float(start)})
        return c

    def shuffled(self) -> list:
        """The events in a seeded random order (a join must not depend on
        the file's order)."""
        order = self.rng.permutation(len(self.events))
        return [self.events[i] for i in order]


def span(name: str, ts: float = 100.0, dur_s: float = 1e-3, flops=None, **attrs) -> dict:
    """An entry span record of the merged artifact."""
    r = {"v": 1, "type": "span", "ts": ts, "name": name, "dur_s": dur_s, "depth": 0,
         "parent": None, "attrs": attrs, "rank": 0, "fenced": False}
    if flops is not None:
        r["flops"] = flops
    return r


def serial_steps(n_steps: int = 3, host_lead: float = 5000.0, seed: int = 0,
                 algo: str = "chol", entry: str = "chol_entry", phases=("panel", "bulk")):
    """A serial step timeline whose host runs ``host_lead`` us ahead of the
    device: step k's ops run over ``[200k, 200k + 200]`` us in 100 us
    phases, each launched inside ``<algo>.step<k>.<phase>``, every range
    closed long before its kernel runs. Returns (Trace, records)."""
    t = Trace(seed)
    n_ph = len(phases)
    t.range(entry, 0.0, 50.0 * n_steps * n_ph + 10.0)
    for k in range(n_steps):
        t.range(f"{algo}.step{k:03d}", 50.0 * n_ph * k, 50.0 * n_ph)
        for j, ph in enumerate(phases):
            h0 = 50.0 * (n_ph * k + j)
            t.range(f"{algo}.step{k:03d}.{ph}", h0, 50.0)
            d0 = host_lead + 200.0 * k + 100.0 * j * 2 / n_ph
            t.launch(h0 + 10.0, "void strip_kernel<float, 8>(float const*)", d0, 200.0 / n_ph)
    return t, [span(entry, flops=1e6, n=n_steps * 32, nb=32, lookahead=1)]
