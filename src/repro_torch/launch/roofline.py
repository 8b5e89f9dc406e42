"""Roofline of the dry-run records on H100s: the port of
``repro.launch.roofline``, for one card and per rank of a mesh.

Per (arch x shape) cell, from :mod:`.dryrun`'s record:

  compute term    = max(FLOPs, MODEL_FLOPS / chips) / PEAK_FLOPS_BF16
  memory term     = bytes / HBM_BW
  collective term = collective bytes / ici_bw_per_link

with MODEL_FLOPS = 6 N_active tokens for training and 2 N_active tokens
for prefill and decode (tokens: the global batch's B S, or B for a decode
step), ``chips`` the record's (1 for one card) and the constants of
:mod:`repro_torch.core.costmodel`: ``HardwareModel().ici_bw_per_link`` is
one NVLink link's 25 GB/s, a data-sheet figure.  A rank's FLOPs, bytes and
collective bytes are its own (the per-rank dry run's), so the terms are a
rank's times.  ``per_device_gb`` is the dry run's peak (arguments plus
temporaries), a rank's on a mesh, and ``fits_80gb`` whether it stays
within the card's 80 GB.  Every number is computed from shapes, not
measured.  A mesh of 256 or 512 ranks spans nodes (8 H100s a node on
NVLink), so its collectives cross InfiniBand too, slower than a link:
the collective term is a lower bound.

The JAX module's ``extrapolate`` and ``proxy_depths`` are left out: they
correct XLA's cost analysis, which counts a ``lax.scan`` body once, from
two unrolled shallow compiles; the port's counter runs eagerly and sees
every layer, so its counts need no correction.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh both]

reads ``experiments/dryrun_torch/*.json`` and writes
``experiments/roofline_torch_<mesh>.json`` and ``.md`` (the table,
printed), ``<mesh>`` ``h100`` (one card, the default), ``h100_16x16`` or
``h100_2x16x16``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Any, Dict, List, Optional

from ..configs import ARCH_IDS, SHAPES, get_shape
from ..core.costmodel import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                              HardwareModel)
from .dryrun import (COLLECTIVE_OPS, DEVICE, RESULTS_DIR as DRYRUN_DIR,
                     mesh_name)
from .mesh import MESHES

RESULTS_DIR = DRYRUN_DIR.parent


def _load(name: str, in_dir: pathlib.Path = DRYRUN_DIR
          ) -> Optional[Dict[str, Any]]:
    p = in_dir / f"{name}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def _tokens(rec: Dict[str, Any]) -> int:
    if "tokens" in rec:
        return int(rec["tokens"])
    shape = get_shape(rec["shape"])
    return shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)


def analyze_cell(rec: Optional[Dict[str, Any]], *,
                 chips: Optional[int] = None,
                 peak_flops: float = PEAK_FLOPS_BF16, hbm_bw: float = HBM_BW,
                 link_bw: float = HardwareModel(chips=1).ici_bw_per_link,
                 hbm_gb: float = HBM_BYTES / 1e9
                 ) -> Optional[Dict[str, Any]]:
    """The roofline terms of one dry-run record (a skipped or missing
    record comes back as it is); ``chips`` is the record's unless
    given."""
    if rec is None or rec.get("skipped"):
        return rec
    if chips is None:
        chips = int(rec.get("chips", 1))
    cost, coll = rec.get("cost", {}), rec.get("collectives", {})
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll_bytes = float(sum(coll.get(op, 0) for op in COLLECTIVE_OPS))
    factor = 6 if rec["kind"] == "train" else 2
    model_flops = factor * rec["n_active_params"] * _tokens(rec) / chips
    compute_t = max(flops, model_flops) / peak_flops
    memory_t = nbytes / hbm_bw
    coll_t = coll_bytes / link_bw
    dom = max(("compute", compute_t), ("memory", memory_t),
              ("collective", coll_t), key=lambda kv: kv[1])
    mem = rec.get("memory", {})
    per_dev_gb = ((mem.get("argument_size_in_bytes", 0)
                   + mem.get("temp_size_in_bytes", 0)) / 1e9
                  if mem.get("available") else None)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec.get("mesh"),
        "chips": chips, "method": "eager count (every layer)",
        "compute_s": compute_t, "memory_s": memory_t,
        "collective_s": coll_t,
        "dominant": dom[0],
        "roofline_frac": (max(compute_t, memory_t, coll_t) and
                          compute_t / max(compute_t, memory_t, coll_t)),
        "model_flops_per_chip": model_flops,
        "useful_ratio": model_flops / flops if flops else 0,
        "per_device_gb": per_dev_gb,
        "fits_80gb": per_dev_gb is not None and per_dev_gb <= hbm_gb,
        "bound_s": max(compute_t, memory_t, coll_t),
        "kernels": rec.get("kernels", {}),
        "collective_bytes": {op: coll.get(op, 0) for op in COLLECTIVE_OPS},
    }


def table(rows: List[Dict[str, Any]], coll: bool = False) -> str:
    """The markdown table of :func:`analyze_cell`'s rows; with ``coll``
    also each cell's collective GB a rank and the largest op's."""
    extra = " collective GB / rank | largest op |" if coll else ""
    md = ["| arch | shape | compute s | memory s | collective s | dominant "
          "| useful FLOPs ratio | GB | fits 80 GB |" + extra,
          "|---|---|---|---|---|---|---|---|---|" + ("---|---|" if coll
                                                      else "")]
    for r in rows:
        if r.get("skipped"):
            md.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                      f"SKIP: {r['skipped'][:40]}… | — | — | — |"
                      + (" — | — |" if coll else ""))
            continue
        gb = ("n/a" if r["per_device_gb"] is None
              else f"{r['per_device_gb']:.2f}")
        line = (f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4g} | "
                f"{r['memory_s']:.4g} | {r['collective_s']:.4g} | "
                f"{r['dominant']} | {r['useful_ratio']:.3f} | {gb} | "
                f"{'yes' if r['fits_80gb'] else 'no'} |")
        if coll:
            by_op = r["collective_bytes"]
            top = max(by_op, key=by_op.get)
            line += (f" {sum(by_op.values()) / 1e9:.4g} | "
                     f"{top if by_op[top] else '—'} |")
        md.append(line)
    return "\n".join(md)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-dir", type=pathlib.Path, default=DRYRUN_DIR)
    ap.add_argument("--out", type=pathlib.Path, default=RESULTS_DIR)
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"],
                    default="card", help="the table of one card (default) "
                    "or of a rank of the (1, 16, 16) or (2, 16, 16) mesh")
    args = ap.parse_args(argv)
    names = {"card": [DEVICE],
             "single": [mesh_name(MESHES["single"])],
             "multi": [mesh_name(MESHES["multi"])],
             "both": [mesh_name(MESHES[m]) for m in ("single", "multi")]
             }[args.mesh]
    args.out.mkdir(parents=True, exist_ok=True)
    for name in names:
        rows = []
        for arch in ARCH_IDS:
            for sh in SHAPES:
                cell = analyze_cell(_load(f"{arch}_{sh.name}_{name}",
                                          args.dryrun_dir))
                if cell is not None:
                    rows.append(cell)
        md = table(rows, coll=name != DEVICE)
        (args.out / f"roofline_torch_{name}.json").write_text(
            json.dumps(rows, indent=2))
        (args.out / f"roofline_torch_{name}.md").write_text(md + "\n")
        print(f"## {name}\n\n{md}")
        if name == DEVICE:
            print(f"\n{len(rows)} cells; computed from shapes for one "
                  f"NVIDIA H100 (peak {PEAK_FLOPS_BF16:.3g} FLOP/s bf16, "
                  f"{HBM_BW:.3g} B/s HBM, {HBM_BYTES / 1e9:.0f} GB), not "
                  f"measured\n")
        else:
            link = HardwareModel(chips=1).ici_bw_per_link
            print(f"\n{len(rows)} cells; computed from shapes for one rank "
                  f"of a mesh of NVIDIA H100 ranks (the collective term at "
                  f"one NVLink link, {link:.3g} B/s: a lower bound across "
                  f"nodes), not measured\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
