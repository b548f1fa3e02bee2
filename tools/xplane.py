"""Minimal XSpace (.xplane.pb) reader — no tensorflow dependency.

jax.profiler.trace writes TensorFlow XSpace protos; this decodes them
with a generic protobuf walker (field numbers from
tensorflow/core/profiler/protobuf/xplane.proto) and aggregates
device-op durations so "where does the step go" is answerable from a
bare environment.

Usage:
    python tools/xplane.py <trace_dir_or_pb> [--top N] [--group]

--group folds XLA fusion names into coarse buckets (fusion, dynamic-
update-slice, copy/transpose, reduce, dot, custom-call, ...).
"""

from __future__ import annotations

import struct
import sys
from collections import defaultdict


def _varint(buf, i):
    r = 0
    s = 0
    while True:
        b = buf[i]
        r |= (b & 0x7F) << s
        i += 1
        if not b & 0x80:
            return r, i
        s += 7


def fields(buf):
    """Yield (field_number, wire_type, value) over a proto buffer."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"wire type {wt}")
        yield fn, wt, v


def parse(path):
    """-> list of planes: {name, lines: [{name, events:[(meta_id,
    dur_ps)]}], event_names: {id: name}}."""
    with open(path, "rb") as f:
        space = f.read()
    planes = []
    for fn, _, v in fields(space):
        if fn != 1:
            continue
        plane = {"name": "", "lines": [], "event_names": {}}
        for pf, _, pv in fields(v):
            if pf == 2:
                plane["name"] = pv.decode()
            elif pf == 3:
                line = {"name": "", "events": []}
                for lf, _, lv in fields(pv):
                    if lf == 2:
                        line["name"] = lv.decode()
                    elif lf == 11:
                        line["display_name"] = lv.decode()
                    elif lf == 4:
                        mid = dur = 0
                        for ef, _, ev in fields(lv):
                            if ef == 1:
                                mid = ev
                            elif ef == 3:
                                dur = ev
                        line["events"].append((mid, dur))
                plane["lines"].append(line)
            elif pf == 4:
                # map<int64, XEventMetadata>
                k = None
                name = ""
                for mf, _, mv in fields(pv):
                    if mf == 1:
                        k = mv
                    elif mf == 2:
                        for emf, _, emv in fields(mv):
                            if emf == 2:
                                name = emv.decode()
                if k is not None:
                    plane["event_names"][k] = name
        planes.append(plane)
    return planes


def device_op_totals(planes):
    """Aggregate duration by op name over device (accelerator)
    planes' XLA-op lines. Returns {name: total_ps}."""
    tot = defaultdict(int)
    for plane in planes:
        nm = plane["name"]
        if "GPU" not in nm and "device" not in nm:
            continue
        for line in plane["lines"]:
            lname = line.get("display_name") or line["name"]
            if "XLA Op" not in lname and "Ops" not in lname:
                continue
            for mid, dur in line["events"]:
                tot[plane["event_names"].get(mid, f"#{mid}")] += dur
    return dict(tot)


GROUPS = (
    ("dynamic-update-slice", "dynamic-update-slice (relayout/scan)"),
    ("dynamic-slice", "dynamic-slice"),
    ("all-reduce", "all-reduce"),
    ("copy", "copy/transpose"),
    ("transpose", "copy/transpose"),
    ("gather", "gather"),
    ("scatter", "scatter"),
    ("reduce", "reduce"),
    ("dot", "dot/matmul"),
    ("conv", "conv"),
    ("custom-call", "custom-call (pallas)"),
    ("while", "while-overhead"),
    ("fusion", "fusion (elementwise etc.)"),
)


def group_name(op):
    base = op.split(".")[0].split("_")[0]
    for key, g in GROUPS:
        if key in op.lower()[:40] or key == base:
            return g
    return base or op


def main(argv):
    path = argv[1]
    import os

    if os.path.isdir(path):
        cands = []
        for root, _, fs in os.walk(path):
            cands += [os.path.join(root, f) for f in fs
                      if f.endswith(".xplane.pb")]
        path = sorted(cands)[-1]
    top = 30
    group = "--group" in argv
    if "--top" in argv:
        top = int(argv[argv.index("--top") + 1])
    planes = parse(path)
    tot = device_op_totals(planes)
    if group:
        g = defaultdict(int)
        for k, v in tot.items():
            g[group_name(k)] += v
        tot = dict(g)
    total = sum(tot.values())
    print(f"# {path}")
    print(f"{'op':60s} {'ms':>10s} {'%':>6s}")
    for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{k[:60]:60s} {v / 1e9:10.3f} {100 * v / total:6.2f}")
    print(f"{'TOTAL device time':60s} {total / 1e9:10.3f}")


if __name__ == "__main__":
    main(sys.argv)
