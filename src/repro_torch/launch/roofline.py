"""Roofline of the dry-run records on one H100: the port of
``repro.launch.roofline`` for one card (``chips = 1``).

Per (arch x shape) cell, from :mod:`.dryrun`'s record:

  compute term    = max(FLOPs, MODEL_FLOPS) / PEAK_FLOPS_BF16
  memory term     = bytes / HBM_BW
  collective term = 0 (one card: the record's collectives are zero)

with MODEL_FLOPS = 6 N_active tokens for training and 2 N_active tokens
for prefill and decode (tokens: B S, or B for a decode step), and the
constants of :mod:`repro_torch.core.costmodel`.  ``per_device_gb`` is the
dry run's peak (arguments plus temporaries) and ``fits_80gb`` whether it
stays within the card's 80 GB.  Every number is computed from shapes, not
measured.

The JAX module's ``extrapolate`` and ``proxy_depths`` are left out: they
correct XLA's cost analysis, which counts a ``lax.scan`` body once, from
two unrolled shallow compiles; the port's counter runs eagerly and sees
every layer, so its counts need no correction.

  PYTHONPATH=src python -m repro_torch.launch.roofline

reads ``experiments/dryrun_torch/*.json`` and writes
``experiments/roofline_torch_h100.json`` and ``.md`` (the table, printed).
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Any, Dict, List, Optional

from ..configs import ARCH_IDS, SHAPES, get_shape
from ..core.costmodel import (HBM_BW, HBM_BYTES, NVLINK_BW_PER_LINK,
                              PEAK_FLOPS_BF16)
from .dryrun import COLLECTIVE_OPS, DEVICE, RESULTS_DIR as DRYRUN_DIR

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


def analyze_cell(rec: Optional[Dict[str, Any]], *, chips: int = 1,
                 peak_flops: float = PEAK_FLOPS_BF16, hbm_bw: float = HBM_BW,
                 link_bw: float = NVLINK_BW_PER_LINK,
                 hbm_gb: float = HBM_BYTES / 1e9
                 ) -> Optional[Dict[str, Any]]:
    """The roofline terms of one dry-run record (a skipped or missing
    record comes back as it is)."""
    if rec is None or rec.get("skipped"):
        return rec
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
    }


def table(rows: List[Dict[str, Any]]) -> str:
    """The markdown table of :func:`analyze_cell`'s rows."""
    md = ["| arch | shape | compute s | memory s | collective s | dominant "
          "| useful FLOPs ratio | GB | fits 80 GB |",
          "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped"):
            md.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                      f"SKIP: {r['skipped'][:40]}… | — | — | — |")
            continue
        gb = ("n/a" if r["per_device_gb"] is None
              else f"{r['per_device_gb']:.2f}")
        md.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4g} | "
            f"{r['memory_s']:.4g} | {r['collective_s']:.4g} | "
            f"{r['dominant']} | {r['useful_ratio']:.3f} | {gb} | "
            f"{'yes' if r['fits_80gb'] else 'no'} |")
    return "\n".join(md)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-dir", type=pathlib.Path, default=DRYRUN_DIR)
    ap.add_argument("--out", type=pathlib.Path, default=RESULTS_DIR)
    args = ap.parse_args(argv)
    rows = []
    for arch in ARCH_IDS:
        for sh in SHAPES:
            cell = analyze_cell(_load(f"{arch}_{sh.name}_{DEVICE}",
                                      args.dryrun_dir))
            if cell is not None:
                rows.append(cell)
    md = table(rows)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"roofline_torch_{DEVICE}.json").write_text(
        json.dumps(rows, indent=2))
    (args.out / f"roofline_torch_{DEVICE}.md").write_text(md + "\n")
    print(md)
    print(f"\n{len(rows)} cells; computed from shapes for one NVIDIA H100 "
          f"(peak {PEAK_FLOPS_BF16:.3g} FLOP/s bf16, {HBM_BW:.3g} B/s HBM, "
          f"{HBM_BYTES / 1e9:.0f} GB), not measured")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
