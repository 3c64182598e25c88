"""Stratified page sampling for training-set construction (the port's copy
of ``karanta_tpu/data/sampler.py``).

Reference karanta/data/create_training_docs_azure.py:11-173: systematic
sampling within folders, proportional/balanced allocation across folders,
and a two-phase scheme guaranteeing per-folder coverage before filling
proportionally. Operates on a catalog of (folder, document, pages) rows
(CSV in the reference; plain dict rows here) and returns sampled
(folder, document, page) triples.
"""

from __future__ import annotations

import argparse
import csv
import json
from collections import defaultdict
from typing import Optional

import numpy as np


def systematic_sample(n_items: int, n_samples: int,
                      rng: np.random.Generator) -> list[int]:
    """Evenly spaced sample with a random phase (reference :11-41)."""
    if n_samples >= n_items:
        return list(range(n_items))
    if n_samples <= 0:
        return []
    step = n_items / n_samples
    start = float(rng.uniform(0, step))
    return sorted({min(int(start + i * step), n_items - 1)
                   for i in range(n_samples)})


def allocate_samples(folder_sizes: dict[str, int], total: int,
                     mode: str = "proportional",
                     min_per_folder: int = 0) -> dict[str, int]:
    """Split a sampling budget across folders (reference :44-91)."""
    folders = list(folder_sizes)
    if not folders or total <= 0:
        return {f: 0 for f in folders}
    if mode == "balanced":
        per = total // len(folders)
        alloc = {f: min(per, folder_sizes[f]) for f in folders}
    elif mode == "proportional":
        grand = sum(folder_sizes.values()) or 1
        alloc = {f: min(folder_sizes[f],
                        int(round(total * folder_sizes[f] / grand)))
                 for f in folders}
    else:
        raise ValueError(f"unknown allocation mode {mode!r}")
    for f in folders:
        alloc[f] = max(alloc[f], min(min_per_folder, folder_sizes[f]))
    # trim any overshoot from the largest allocations
    excess = sum(alloc.values()) - total
    for f in sorted(folders, key=lambda x: -alloc[x]):
        if excess <= 0:
            break
        cut = min(excess, alloc[f] - min(min_per_folder, folder_sizes[f]))
        alloc[f] -= cut
        excess -= cut
    return alloc


def two_phase_sample(catalog: list[dict], total: int,
                     coverage_per_folder: int = 1,
                     seed: int = 0) -> list[dict]:
    """Phase 1: guarantee every folder contributes >= coverage_per_folder
    pages; phase 2: fill the remaining budget proportionally
    (reference :94-173).

    catalog rows: {"folder": str, "document": str, "pages": int}.
    Returns rows {"folder", "document", "page"} (1-based pages).
    """
    rng = np.random.default_rng(seed)
    by_folder: dict[str, list[dict]] = defaultdict(list)
    for row in catalog:
        by_folder[row["folder"]].append(row)

    folder_pages = {
        f: sum(int(r["pages"]) for r in rows)
        for f, rows in by_folder.items()
    }
    alloc = allocate_samples(folder_pages, total, "proportional",
                             min_per_folder=coverage_per_folder)

    sampled: list[dict] = []
    for folder, budget in alloc.items():
        # flatten this folder's pages: (document, page)
        flat: list[tuple[str, int]] = []
        for row in by_folder[folder]:
            flat.extend((row["document"], p + 1)
                        for p in range(int(row["pages"])))
        for idx in systematic_sample(len(flat), budget, rng):
            doc, page = flat[idx]
            sampled.append({"folder": folder, "document": doc, "page": page})
    return sampled


def read_catalog_csv(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return [{"folder": r["folder"], "document": r["document"],
                 "pages": int(r["pages"])} for r in csv.DictReader(f)]


def write_samples_csv(path: str, samples: list[dict]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["folder", "document", "page"])
        writer.writeheader()
        writer.writerows(samples)


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.data.sampler")
    parser.add_argument("--catalog", required=True,
                        help="CSV with folder,document,pages columns")
    parser.add_argument("--output", required=True)
    parser.add_argument("--total", type=int, required=True)
    parser.add_argument("--coverage", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    samples = two_phase_sample(read_catalog_csv(args.catalog), args.total,
                               args.coverage, args.seed)
    write_samples_csv(args.output, samples)
    print(json.dumps({"sampled": len(samples)}))


if __name__ == "__main__":
    main()
