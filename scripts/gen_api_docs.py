"""Generate the API reference (docs/api.md) by introspection.

The reference ships sphinx autodoc pages (``docs/source/apis/*.rst``);
this environment has no sphinx, so this script walks the public API the
same way autodoc would — module by module, pulling signatures and
docstrings — and emits one markdown page. Regenerate after API changes:

    python scripts/gen_api_docs.py        # writes docs/api.md
    python scripts/gen_api_docs.py --check  # CI: fail if stale
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# (module, heading, blurb) — the public surface, grouped as the
# reference's docs group theirs (apis/{grid,rendering,utils}.rst)
SECTIONS = [
    ("nerfacc_tpu", "Package exports",
     "Everything importable from `nerfacc_tpu` directly — the reference's "
     "21 exports plus the dense twins and static-shape helpers."),
    ("nerfacc_tpu.grid", "Occupancy grid", None),
    ("nerfacc_tpu.ray_marching", "Ray marching", None),
    ("nerfacc_tpu.vol_rendering", "Volume rendering", None),
    ("nerfacc_tpu.cdf", "CDF resampling", None),
    ("nerfacc_tpu.pack", "Pack / unpack", None),
    ("nerfacc_tpu.contraction", "Contraction", None),
    ("nerfacc_tpu.intersection", "Ray-AABB intersection", None),
    ("nerfacc_tpu.losses", "Losses", None),
    ("nerfacc_tpu.sampling", "Proposal sampling", None),
    ("nerfacc_tpu.scan", "Segmented scans", None),
    ("nerfacc_tpu.utils", "Rendering helpers", None),
    ("nerfacc_tpu.checkpoint", "Checkpointing", None),
    ("nerfacc_tpu.parallel", "Multi-chip parallelism", None),
    ("nerfacc_tpu.models", "Example radiance fields", None),
    ("nerfacc_tpu.datasets", "Datasets", None),
]


def _first_para(doc: str | None) -> str:
    if not doc:
        return "*(undocumented)*"
    doc = inspect.cleandoc(doc)
    para = doc.split("\n\n", 1)[0].replace("\n", " ").strip()
    return para


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in sorted(names):
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        # only document things defined in (or re-exported by) the package
        m = getattr(obj, "__module__", "") or ""
        if not (m.startswith("nerfacc_tpu") or mod.__name__ == "nerfacc_tpu"):
            continue
        out.append((n, obj))
    return out


def generate() -> str:
    lines = [
        "# API reference",
        "",
        "Generated by `scripts/gen_api_docs.py` — do not edit by hand.",
        "Parity mapping to the reference toolbox is in `PARITY.md`; design",
        "rationale lives in each module's docstring and",
        "`docs/benchmarks.md`.",
        "",
    ]
    seen_in_root = set()
    for mod_name, heading, blurb in SECTIONS:
        mod = importlib.import_module(mod_name)
        lines.append(f"## {heading} — `{mod_name}`")
        lines.append("")
        blurb = blurb or _first_para(mod.__doc__)
        lines.append(blurb)
        lines.append("")
        for name, obj in _public_members(mod):
            if mod_name == "nerfacc_tpu":
                seen_in_root.add(name)
            elif name in seen_in_root:
                continue  # already documented as a package export
            if inspect.isclass(obj):
                lines.append(f"### `{name}`")
                lines.append("")
                lines.append(_first_para(obj.__doc__))
                lines.append("")
                methods = [
                    (mn, mo)
                    for mn, mo in inspect.getmembers(obj, inspect.isfunction)
                    if not mn.startswith("_") and mo.__qualname__.startswith(
                        obj.__name__
                    )
                ]
                for mn, mo in methods:
                    lines.append(f"- **`.{mn}{_signature(mo)}`** — "
                                 f"{_first_para(mo.__doc__)}")
                if methods:
                    lines.append("")
            elif callable(obj):
                lines.append(f"### `{name}{_signature(obj)}`")
                lines.append("")
                lines.append(_first_para(obj.__doc__))
                lines.append("")
            else:
                lines.append(f"### `{name}` = `{obj!r}`")
                lines.append("")
    return "\n".join(lines) + "\n"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if docs/api.md is stale")
    args = ap.parse_args()
    out = REPO / "docs" / "api.md"
    text = generate()
    if args.check:
        if not out.exists() or out.read_text() != text:
            print("docs/api.md is stale — run scripts/gen_api_docs.py",
                  file=sys.stderr)
            sys.exit(1)
        print("docs/api.md up to date")
        return
    out.write_text(text)
    n_entries = text.count("\n### ")
    print(f"wrote {out} ({n_entries} entries)")


if __name__ == "__main__":
    main()
