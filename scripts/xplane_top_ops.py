"""Minimal self-contained xplane.pb top-op extractor.

The tensorboard_plugin_profile/tensorflow pywrap converters in this image
disagree about protobuf versions, so this parses the XSpace protobuf WIRE
FORMAT directly (no generated code): finds the GPU device planes,
aggregates event durations by event-metadata name, and prints a top-op
table. Used for the per-round kernel traces cited in docs/SCALING.md
§5.1 and the DP overlap experiment (§5.2).

Usage:
    python scripts/xplane_top_ops.py <trace_dir_or_xplane.pb> [--steps N]
                                     [--top K] [--line-filter SUBSTR]
"""

import argparse
import glob
import os
import sys
from collections import defaultdict


def read_varint(buf, i):
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def iter_fields(buf):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:                      # varint
            val, i = read_varint(buf, i)
        elif wt == 1:                    # 64-bit
            val = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wt == 2:                    # length-delimited
            ln, i = read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:                    # 32-bit
            val = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def parse_plane(buf):
    """XPlane: name=2, lines=3, event_metadata=4 (map<int64, XEventMetadata
    {id=1, name=2, display_name=4}>)."""
    name, lines, meta = "", [], {}
    for f, wt, v in iter_fields(buf):
        if f == 2 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif f == 3 and wt == 2:
            lines.append(v)
        elif f == 4 and wt == 2:
            key, mname = None, ""
            for f2, wt2, v2 in iter_fields(v):     # map entry
                if f2 == 1 and wt2 == 0:
                    key = v2
                elif f2 == 2 and wt2 == 2:
                    for f3, wt3, v3 in iter_fields(v2):  # XEventMetadata
                        if f3 == 1 and wt3 == 0:
                            key = v3
                        elif f3 == 2 and wt3 == 2:
                            mname = v3.decode("utf-8", "replace")
            if key is not None:
                meta[key] = mname
    return name, lines, meta


def parse_line(buf):
    """XLine: name=2, display_name=11, events=4 (XEvent {metadata_id=1,
    duration_ps=3})."""
    name, events = "", []
    for f, wt, v in iter_fields(buf):
        if f == 2 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif f == 11 and wt == 2:
            name = v.decode("utf-8", "replace") or name
        elif f == 4 and wt == 2:
            mid, dur = None, 0
            for f2, wt2, v2 in iter_fields(v):
                if f2 == 1 and wt2 == 0:
                    mid = v2
                elif f2 == 3 and wt2 == 0:
                    dur = v2
            if mid is not None:
                events.append((mid, dur))
    return name, events


def top_ops(path, steps=1, top=25, line_filter=None):
    buf = open(path, "rb").read()
    rows = []
    for f, wt, v in iter_fields(buf):            # XSpace: planes=1
        if f != 1 or wt != 2:
            continue
        pname, lines, meta = parse_plane(v)
        if "/device:GPU" not in pname:
            continue
        agg = defaultdict(lambda: [0, 0])        # name -> [ps, count]
        for lb in lines:
            lname, events = parse_line(lb)
            if line_filter and line_filter not in lname:
                continue
            for mid, dur in events:
                a = agg[meta.get(mid, f"meta{mid}")]
                a[0] += dur
                a[1] += 1
        rows.append((pname, agg))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--line-filter", default=None,
                    help="only lines whose name contains this (e.g. "
                         "'XLA Ops')")
    args = ap.parse_args()

    path = args.path
    if os.path.isdir(path):
        cands = sorted(glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                                 recursive=True))
        if not cands:
            sys.exit(f"no xplane.pb under {path}")
        path = cands[-1]
    print(f"# {path}")
    for pname, agg in top_ops(path, line_filter=args.line_filter):
        print(f"\n== plane: {pname}")
        items = sorted(agg.items(), key=lambda kv: -kv[1][0])[:args.top]
        total = sum(ps for ps, _ in agg.values())
        print(f"{'ms/step':>9} {'%':>5} {'count':>7}  op")
        for name, (ps, cnt) in items:
            ms = ps / 1e12 * 1e3 / args.steps
            print(f"{ms:9.3f} {100 * ps / max(total, 1):5.1f} {cnt:7d}  "
                  f"{name[:100]}")
        print(f"total device time: {total / 1e12 * 1e3 / args.steps:.3f} "
              f"ms/step over {args.steps} steps")


if __name__ == "__main__":
    main()
