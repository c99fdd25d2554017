"""Device time per layer from a ``jax.profiler`` trace.

    python scripts/xplane.py TRACE_DIR [--steps N] [--top K]

Reads the newest ``*.xplane.pb`` under ``TRACE_DIR`` with
``jax.profiler.ProfileData`` and sums the durations of the kernels on each
GPU plane. Each kernel is attributed to a layer by the ``jax.named_scope``
in the HLO ``op_name`` metadata of the instruction it runs (``probe``,
``slot_select``, ``cp_level``, ``hash_table_grad``, ...), read from the
optimized HLO text that ``bench.py --trace`` writes beside the trace
(``TRACE_DIR/*.hlo.txt``); a fusion gets the layer most of its fused
instructions carry. ``bwd`` marks kernels under ``transpose(...)``, the
backward pass. Also prints the window, the busy time (union of kernel
intervals) and the idle share. Times are per step when ``--steps`` is
given. Library kernels (cuBLAS) launched from a command buffer carry no
instruction name; run the traced program with
``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` to attribute them too.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import sys

# most specific first: a name stack can hold several of these
LAYERS = (
    "hash_table_grad", "hash_encode", "cp_level", "reselect", "slot_select",
    "recheck", "probe", "compact", "composite", "field", "optimizer",
)

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\(.*\))?.*\{\s*$")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def layer_of(op_name: str) -> str:
    for layer in LAYERS:
        if re.search(rf"(^|[/(]){layer}([/)]|$)", op_name):
            return layer
    return "other"


def parse_hlo(text: str) -> dict:
    """Instruction name -> (layer, is_backward), by majority over the
    instruction's own op_name and those of the computations it calls."""
    own, calls, comp_ops = {}, {}, collections.defaultdict(list)
    comp = None
    for line in text.splitlines():
        m = _INSTR.match(line)
        if m and "=" in line.split("{")[0]:
            name, rest = m.groups()
            ops = _OPNAME.findall(rest)
            own[name] = ops
            if comp is not None:
                comp_ops[comp].extend(ops)
            c = _CALLS.search(rest)
            if c:
                calls[name] = c.group(1)
            continue
        m = _COMP.match(line)
        if m:
            comp = m.group(1)
    out = {}
    for name, ops in own.items():
        ops = ops + comp_ops.get(calls.get(name), [])
        if not ops:
            continue
        votes = collections.Counter(
            (layer_of(o), "transpose(" in o) for o in ops
        )
        out[name] = votes.most_common(1)[0][0]
    return out


def reduce_trace(path: str, hlo: dict, top: int = 15) -> dict:
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    result = {}
    for plane in pd.planes:
        if "/device:GPU" not in plane.name:
            continue
        per = collections.defaultdict(float)
        unattributed = collections.Counter()
        intervals = []
        for line in plane.lines:
            for ev in line.events:
                dur = ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + dur))
                # the event's HLO instruction; inside a command buffer
                # (CUDA graph) only the kernel name, which is the fusion's
                # name with "." -> "_", says which instruction ran
                op = str(dict(ev.stats).get("hlo_op", ""))
                name = str(ev.name)
                key = (hlo.get(op) or hlo.get(name)
                       or hlo.get(re.sub(r"_(\d+)$", r".\1", name)))
                if key is None:
                    per[("other", False)] += dur
                    unattributed[ev.name] += dur
                else:
                    per[key] += dur
        if not intervals:
            continue
        intervals.sort()
        busy, cur_s, cur_e = 0.0, *intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in intervals) - intervals[0][0]
        result[plane.name] = {
            "layers": dict(per), "busy_ns": busy, "window_ns": window,
            "unattributed": unattributed.most_common(top),
        }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    paths = sorted(
        glob.glob(f"{args.trace_dir}/**/*.xplane.pb", recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        print(f"no trace under {args.trace_dir}", file=sys.stderr)
        return 1
    hlo = {}
    for f in glob.glob(f"{args.trace_dir}/*.hlo.txt"):
        with open(f) as fh:
            hlo.update(parse_hlo(fh.read()))
    res = reduce_trace(paths[-1], hlo, args.top)
    n = max(args.steps, 1)
    for plane, r in res.items():
        print(f"== {plane}: window {r['window_ns'] / n / 1e6:.3f} ms/step, "
              f"busy {r['busy_ns'] / n / 1e6:.3f} ms/step, idle share "
              f"{1 - r['busy_ns'] / r['window_ns']:.4f}")
        total = sum(r["layers"].values())
        for (layer, bwd), ns in sorted(r["layers"].items(),
                                       key=lambda kv: -kv[1]):
            print(f"  {layer:16s} {'bwd' if bwd else 'fwd'} "
                  f"{ns / n / 1e6:9.4f} ms/step  {100 * ns / total:5.1f}%")
        for name, ns in r["unattributed"]:
            print(f"    unattributed {ns / n / 1e6:9.4f} ms/step  {name[:80]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
