"""Roofline report: three terms per (arch x shape x mesh) from dry-run JSON
(the port of ``repro.launch.roofline``, with an H100's peaks).

    PYTHONPATH=src python -m repro_torch.launch.roofline
        [--dir dryrun_results] [--markdown] [--mesh 16x16|2x16x16]

Terms, per step, from a report's per-device numbers:
  compute    = flops            / PEAK_FLOPS
  memory     = bytes_accessed   / HBM_BW
  collective = collective_bytes / LINK_BW   (its "total")

Constants, one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense rates):
  PEAK_FLOPS = 989.4e12 FLOP/s  bf16 tensor cores, without sparsity
  HBM_BW     = 3.35e12  B/s     HBM3
  LINK_BW    = 50e9     B/s     one 400 Gb/s InfiniBand NDR port a GPU (the
                                ConnectX-7 of a DGX H100 node): a mesh of
                                256 GPUs spans 32 nodes of 8, so the
                                collectives of the axis that leaves a node
                                run at this rate, not NVLink's 450 GB/s
                                each way inside it

MODEL_FLOPS = 6 N T for training (N = the active parameters, T the
tokens), 2 N T for prefill and decode.  ``useful_ratio`` = MODEL_FLOPS /
(flops x chips) exposes recompute and redundant work; ``roofline_frac``
is the model FLOPs a chip could do a second at the bound term, over
PEAK_FLOPS.  ``hbm_gib_per_dev`` = (argument_bytes + temp_bytes) / 2**30,
with a null ``temp_bytes`` (the port's dry run) counted as 0: arguments
only.  The dry run's ``flops`` and ``bytes_accessed`` are per device
already (the global program's, divided by the chips), so each term
divides by one chip's peak.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

PEAK_FLOPS = 989.4e12    # bf16 per chip (H100 SXM, dense)
HBM_BW = 3.35e12         # bytes/s per chip (H100 SXM HBM3)
LINK_BW = 50e9           # bytes/s per chip (one 400 Gb/s InfiniBand port)


def roofline_row(rep: Dict) -> Dict:
    pd = rep["per_device"]
    chips = rep["chips"]
    compute_s = pd["flops"] / PEAK_FLOPS
    memory_s = pd["bytes_accessed"] / HBM_BW
    coll_s = pd["collective_bytes"].get("total", 0.0) / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    n = rep["active_params"]
    tokens = rep["tokens"]
    mult = 6 if rep["shape"].startswith("train") else 2
    model_flops = mult * n * tokens
    hlo_total = pd["flops"] * chips
    useful = model_flops / hlo_total if hlo_total else 0.0
    bound_s = max(terms.values())
    step_flops_rate = model_flops / chips / max(bound_s, 1e-12)
    frac = step_flops_rate / PEAK_FLOPS
    return {
        "arch": rep["arch"], "shape": rep["shape"],
        "mesh": "2x16x16" if rep["multi_pod"] else "16x16",
        "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "model_flops": model_flops, "useful_ratio": useful,
        "roofline_frac": frac,
        "hbm_gib_per_dev": (pd["argument_bytes"]
                            + (pd["temp_bytes"] or 0)) / 2**30,
    }


def load_rows(directory: str) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            rep = json.load(f)
        if rep.get("status") == "ok":
            rows.append(roofline_row(rep))
        elif rep.get("status") == "skipped":
            rows.append({"arch": rep["arch"], "shape": rep["shape"],
                         "mesh": "2x16x16" if rep["multi_pod"] else "16x16",
                         "skipped": rep["reason"]})
    return rows


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="dryrun_results")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--mesh", default=None, choices=["16x16", "2x16x16"])
    args = ap.parse_args(argv)
    rows = load_rows(args.dir)
    if args.mesh:
        rows = [r for r in rows if r.get("mesh") == args.mesh or "skipped" in r]

    if args.markdown:
        print("| arch | shape | mesh | compute | memory | collective | "
              "dominant | useful | roofline% | HBM GiB/dev |")
        print("|---|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            if "skipped" in r:
                print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                      f"— skipped: {r['skipped'][:60]}... | | | | | | |")
                continue
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                  f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
                  f"| {fmt_s(r['collective_s'])} | **{r['dominant']}** "
                  f"| {r['useful_ratio']:.2f} | {r['roofline_frac']*100:.1f}% "
                  f"| {r['hbm_gib_per_dev']:.1f} |")
    else:
        for r in rows:
            if "skipped" in r:
                print(f"{r['arch']:<24}{r['shape']:<14}{r['mesh']:<9}"
                      f"SKIPPED: {r['skipped'][:50]}")
                continue
            print(f"{r['arch']:<24}{r['shape']:<14}{r['mesh']:<9}"
                  f"c={fmt_s(r['compute_s']):>9} m={fmt_s(r['memory_s']):>9} "
                  f"x={fmt_s(r['collective_s']):>9} dom={r['dominant']:<11}"
                  f"useful={r['useful_ratio']:.2f} "
                  f"roof={r['roofline_frac']*100:5.1f}% "
                  f"hbm={r['hbm_gib_per_dev']:6.1f}GiB")


if __name__ == "__main__":
    main()
