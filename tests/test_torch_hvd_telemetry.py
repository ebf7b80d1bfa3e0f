"""The port lane's instruments against the reference's.

One script runs through the reference ``horovod_tpu.torch`` and through
``horovod_tpu_torch.torch`` (``init(device="cpu")``) at 2 ranks, with
``HOROVOD_CYCLE_TIME=20`` so that four allreduces a late rank enqueues
together fuse on both lanes, and ``HOROVOD_DEBUG_PORT=0``: a lone
allreduce, the fused four (twice: the second time from the cache), a
broadcast, an allgather, an alltoall and a reducescatter under a
timeline, between two step marks. Then:

- ``metrics()`` has the reference's sections less those
  ``common/metrics.py`` omits (``wire``, the elastic section's wire
  counters, the wire knobs),
  with the same fields; the op counts and bytes per class, ``cache`` and
  ``fusion.fused_responses`` equal the reference's;
  ``metrics_reset()`` zeroes the counters;
- every event type is one of the reference's (``csrc/events.cc``), with
  the reference's argument names;
- per tensor the timeline's sequence of states is the reference's, the
  collectives mapped ``RING_*`` -> ``GLOO_*`` (``ALLTOALL`` ->
  ``GLOO_ALLTOALL``); the port's file loads as JSON before
  ``stop_timeline`` and opens with ``CLOCK_SYNC``;
- ``debug_port()`` is the bound port, and ``/healthz``, ``/metrics``,
  ``/events`` and ``/requests`` answer 200.
"""

import json
import os
import re
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_hvd_cache import open_lane, run_both
from tests.test_torch_hvd_ops import _compare, _keep

REPO = Path(__file__).resolve().parent.parent
OMITTED = {"wire"}
# The elastic section less the wire's counters (L8), plus the port's own.
ELASTIC_WIRE = {"heals", "retries", "crc_errors"}
ELASTIC_PORT = {"resets", "last_fault"}


def _x(shape, seed, rank):
    rng = np.random.default_rng(seed * 7919 + rank)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def _script(rank, size, impl):
    hvd, _ = open_lane(impl)
    if impl == "ref":
        from horovod_tpu.common.basics import HorovodBasics

        step_mark = HorovodBasics().step_mark
    else:
        from horovod_tpu_torch.common import basics

        step_mark = basics.step_mark
    path = os.path.join(tempfile.mkdtemp(), f"timeline.{rank}.json")
    out = {}
    try:
        step_mark(True)
        hvd.start_timeline(path)
        out["r.single"] = _keep(hvd.allreduce(_x((5,), 1, rank),
                                              name="t.single", op=hvd.Sum))
        for step in range(2):
            if rank == 1:
                time.sleep(0.1)     # rank 0's four wait; rank 1's fuse
            hs = [hvd.allreduce_async(_x((3,), 10 * step + i, rank),
                                      name=f"t.fuse.{i}", op=hvd.Sum)
                  for i in range(4)]
            for i, h in enumerate(hs):
                out[f"r.fuse.{step}.{i}"] = _keep(h.synchronize())
        out["r.bcast"] = _keep(hvd.broadcast(_x((4,), 20, rank), 1,
                                             name="t.bcast"))
        out["r.ag"] = _keep(hvd.allgather(_x((rank + 1, 2), 21, rank),
                                          name="t.ag"))
        out["r.a2a"] = _keep(hvd.alltoall(_x((2 * size, 3), 22, rank),
                                          name="t.a2a"))
        out["r.rs"] = _keep(hvd.reducescatter(_x((2 * size, 2), 23, rank),
                                              name="t.rs", op=hvd.Sum))
        if impl == "port":
            basics.lane().timeline.flush()
            out["timeline.live"] = json.loads(Path(path).read_text())
        hvd.stop_timeline()
        step_mark(False)
        out["timeline"] = json.loads(Path(path).read_text())
        out["metrics"] = hvd.metrics()
        out["events"] = hvd.events()
        hvd.metrics_reset()
        out["metrics.reset"] = hvd.metrics()
        port = hvd.debug_port()
        out["debug_port"] = port
        out["http"] = {p: _get(port, p) for p in (
            "/healthz", "/metrics", "/events?n=4", "/requests")}
        return out
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def lanes():
    return run_both(_script, 2, env={"HOROVOD_CYCLE_TIME": "20",
                                     "HOROVOD_DEBUG_PORT": "0"})


def test_results_match_reference(lanes):
    ref, port = lanes
    for rank in range(2):
        _compare({k: v for k, v in ref[rank].items() if k.startswith("r.")},
                 {k: v for k, v in port[rank].items() if k.startswith("r.")},
                 2)


def _fields(snap):
    return {k: sorted(v) if isinstance(v, dict) and k not in (
        "ops", "device_ops", "control_phase") else None
        for k, v in snap.items()}


def test_metrics_key_set_is_the_references(lanes):
    ref, port = lanes
    for rank in range(2):
        want, got = ref[rank]["metrics"], port[rank]["metrics"]
        assert set(got) == set(want) - OMITTED
        fields = _fields(want)
        fields["knobs"] = ["cycle_time_ms", "fusion_threshold_bytes"]
        fields["elastic"] = sorted(set(fields["elastic"]) - ELASTIC_WIRE
                                   | ELASTIC_PORT)
        assert _fields(got) == {k: fields[k] for k in got}
        assert got["elastic"]["epoch"] == want["elastic"]["epoch"] == 0
        assert got["elastic"]["last_fault"] is None
        assert set(want["knobs"]) >= set(got["knobs"])
        assert got["initialized"] and got["rank"] == rank
        assert got["knobs"] == {"fusion_threshold_bytes": 64 << 20,
                                "cycle_time_ms": 20.0}


def test_counters_equal_the_references(lanes):
    ref, port = lanes
    for rank in range(2):
        want, got = ref[rank]["metrics"], port[rank]["metrics"]
        assert got["ops"] == want["ops"]
        assert got["device_ops"] == want["device_ops"] == {}
        assert got["cache"] == want["cache"]
        assert got["fusion"]["fused_responses"] == \
            want["fusion"]["fused_responses"] == 2
        assert got["errors"] == want["errors"] == 0
    # Second use of the fused four and t.single: hits on both.
    assert port[0]["metrics"]["cache"]["hits"] == 4


def test_metrics_reset_zeroes_the_counters(lanes):
    _, port = lanes
    for out in port:
        snap = out["metrics.reset"]
        assert snap["ops"] == {} and snap["errors"] == 0
        assert snap["fusion"]["fused_responses"] == 0
        assert snap["queue_us"]["count"] == snap["wire_us"]["count"] == 0
        assert snap["straggler"]["last_rank_counts"] == []


def _catalog():
    """The reference's event types and argument names (kEventSpecs)."""
    text = (REPO / "csrc" / "events.cc").read_text()
    block = text[text.index("kEventSpecs"):text.index("};",
                                                      text.index(
                                                          "kEventSpecs"))]
    specs = {}
    for m in re.finditer(r'\{"(\w+)", "(\w*)", "(\w*)", "(\w*)", "(\w*)"\}',
                         block):
        specs[m.group(1)] = {a for a in m.groups()[1:] if a}
    return specs


def test_event_types_are_the_references(lanes):
    ref, port = lanes
    specs = _catalog()
    base = {"seq", "ts_us", "type"}
    for rank in range(2):
        got = {e["type"] for e in port[rank]["events"]}
        assert got <= set(specs), got - set(specs)
        assert {"negotiate_begin", "negotiate_end", "response_launch",
                "step_begin", "step_end", "wait"} <= got
        ref_keys = {e["type"]: set(e) for e in ref[rank]["events"]}
        for e in port[rank]["events"]:
            assert set(e) - base - {"phase_name"} == specs[e["type"]], e
            if e["type"] in ref_keys:
                assert set(e) == ref_keys[e["type"]], (e, ref_keys)
    assert "phase" in {e["type"] for e in port[0]["events"]}


_RENAME = {"ALLTOALL": "GLOO_ALLTOALL"}


def _states(trace, rename):
    """Per tensor, its (phase, name) events in file order."""
    out = {}
    for ev in trace:
        tensor = ev.get("args", {}).get("tensor")
        if tensor is None:
            continue
        name = ev["name"]
        if rename:
            name = _RENAME.get(name, re.sub(r"^RING_", "GLOO_", name))
        out.setdefault(tensor, []).append((ev["ph"], name))
    return out


def test_timeline_states_match_reference(lanes):
    ref, port = lanes
    for rank in range(2):
        want = _states(ref[rank]["timeline"], rename=True)
        got = _states(port[rank]["timeline"], rename=False)
        assert got == want
        assert set(got) >= {"t.single", "t.fuse.0", "t.bcast", "t.ag",
                            "t.a2a", "t.rs"}
        assert ("B", "MEMCPY_IN_FUSION_BUFFER") in got["t.fuse.3"]
        assert ("B", "GLOO_BCAST") in got["t.bcast"]


def test_timeline_is_json_before_stop(lanes):
    _, port = lanes
    for out in port:
        live = out["timeline.live"]
        assert live[0]["name"] == "CLOCK_SYNC" and live[0]["ts"] == 0
        assert live[0]["args"]["unix_us"] > 0
        assert live[-1] == {}
        assert _states(live, False)["t.rs"][-1] == ("i", "DONE")
        assert out["timeline"][0]["name"] == "CLOCK_SYNC"


def test_debug_port_answers(lanes):
    _, port = lanes
    for rank, out in enumerate(port):
        assert isinstance(out["debug_port"], int) and out["debug_port"] > 0
        http = out["http"]
        assert all(status == 200 for status, _ in http.values()), http
        health = json.loads(http["/healthz"][1])
        assert health["initialized"] and health["rank"] == rank
        assert health["debug_port"] == out["debug_port"]
        # The reference's elastic fields.
        assert health["epoch"] == 0 and health["last_fault"] is None
        assert "hvdtpu_op_bytes_total" in http["/metrics"][1]
        assert f'hvdtpu_elastic_epoch{{rank="{rank}"}} 0' in \
            http["/metrics"][1]
        assert len(json.loads(http["/events?n=4"][1])) == 4
        assert json.loads(http["/requests"][1]) == []
