"""Roofline report: three terms per (arch × shape × mesh) from dry-run JSONs,
on an H100's constants, and the counters that the dry run fills them from.

Port of ``repro/launch/roofline.py``, on ``core/asymmetry.py::H100``:

    compute    = flops_per_device / peak_flops          (989 TFLOP/s bf16, dense)
    memory     = hbm_bytes_per_device / hbm_bw          (3.35 TB/s)
    collective = nvlink_wire / nvlink_bw + ib_wire / ib_bw
                                                        (450 GB/s NVLink each way,
                                                         50 GB/s InfiniBand a GPU)

A group that spans ``pod`` (``pod``, ``pod+data``, and ``world`` on a mesh of
pods) crosses the slow fabric and runs at ``ib_bw_per_gpu``; every other
group at ``nvlink_bw``: the reference's DCN/ICI split on the port's cost
model.  The record layout is the reference's, so one record feeds both
versions: ``parsed.ici_wire_bytes_per_chip`` holds the NVLink bytes and
``parsed.dcn_wire_bytes_per_chip`` the InfiniBand bytes.  The report adds the
dominant term, MODEL_FLOPS / counted FLOPs (the useful-compute ratio: remat's
recompute and the capacity buffers' empty slots lower it), the roofline
fraction compute / max(terms), and whether the peak estimate fits the card's
80 GB.  Every number is an estimate on the data sheet's constants.

Where the reference parsed XLA's compiled HLO (``hloparse``), the port counts
one rank's step as it runs on the ``meta`` device (:class:`StepCounter`):

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s formulas
  (``flop_registry``) over every operation (the matmuls, forward and
  backward, remat's recompute among them), applied in the counter's one
  dispatch mode (``FlopCounterMode`` as a second mode doubles a cell's
  time), plus the kernels' own work, which their entry points record on
  ``meta`` (``kernels/work.py``: the causal mask and the window skip masked
  tiles);
* HBM bytes: each operation's inputs read and outputs written, summed over
  the operations (views and allocations move nothing), plus the kernels'
  bytes.  This is the unfused traffic, an upper bound: the reference counted
  after XLA's fusion, where an elementwise chain reads and writes once;
* live bytes: every tensor that an operation allocates, keyed on its
  storage (on ``meta`` ``data_ptr()`` is 0 and views share a storage) and
  freed when the last tensor on it dies; tensors saved for backward count
  while autograd holds them.  The highest sum is the step's temporaries.

A loop that runs one step on ``meta`` (the sLSTM's loop over time,
``models/xlstm.py``) counts that step's FLOPs and bytes once per step
(``kernels.work.repeated``), as the reference's ``hloparse`` multiplies a
while loop's body by its trip count.  Its live bytes are one step's, beside
the other steps' outputs and the loop's stacked outputs at their whole
size; under autograd it holds n times what one step saves for the backward
(``xlstm._saved_by_steps``) until its backward ends.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline --results results/
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..core.asymmetry import H100
from ..kernels import work

HW = H100()

# Operations that allocate without reading or writing anything, and one
# that returns its input's storage though its schema does not say so.
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
_UNMARKED_VIEWS = {"_unsafe_view"}
_COMPOSITES: Dict = {}  # operation -> whether it has a CompositeImplicitAutograd kernel


class _Counted(TorchDispatchMode):
    """FLOPs (``FlopCounterMode``'s formulas), HBM bytes (inputs read,
    outputs written, by operation) and live bytes (by storage) of the
    operations run inside it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, List[int]] = {}  # storage -> [bytes, tensors alive]
        self._refs = set()

    def _release(self, key: int, ref) -> None:
        self._refs.discard(ref)
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [storage.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        self._refs.add(weakref.ref(t, functools.partial(self._release, key)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        flops = flop_registry.get(packet)
        composite = _COMPOSITES.get(func)
        if composite is None:
            composite = _COMPOSITES[func] = func._can_decompose()
        if flops is None and composite:
            # A composite (``linear`` under inference mode) is counted by
            # the operations it decomposes into, as FlopCounterMode does.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = packet.__name__
        if func.is_view or name in _ALLOCATIONS or name in _UNMARKED_VIEWS:
            if name in _ALLOCATIONS:
                self._track(out)
            return out
        n = work.repeats()
        if flops is not None:
            self.flops += n * flops(*args, **kwargs, out_val=out)
        ins, _ = tree_flatten((args, kwargs))
        outs, _ = tree_flatten(out)
        self.bytes += n * sum(t.numel() * t.element_size() for t in ins + outs
                              if isinstance(t, torch.Tensor))
        returns = func._schema.returns
        for i, t in enumerate(outs):
            # An output that aliases an input (in place, ``out=``) allocates nothing.
            alias = returns[i].alias_info if i < len(returns) else None
            if isinstance(t, torch.Tensor) and alias is None:
                self._track(t)
        return out


class StepCounter:
    """FLOPs, HBM bytes and the highest live bytes of what runs inside
    ``with StepCounter() as c:``; after the block ``c.flops``, ``c.bytes``,
    ``c.peak_bytes`` and ``c.kernels`` (launches by kernel on ``meta``)."""

    def __enter__(self):
        self._counted = _Counted()
        self._work = work.recorded()
        self._rec = self._work.__enter__()
        self._counted.__enter__()
        return self

    def __exit__(self, *exc):
        self._counted.__exit__(*exc)
        self._work.__exit__(*exc)
        self.flops = self._counted.flops + self._rec["flops"]
        self.bytes = self._counted.bytes + self._rec["bytes"]
        self.peak_bytes = self._counted.peak
        self.kernels = dict(self._rec["calls"])
        return False


def roofline_terms(rec: Dict) -> Dict:
    p = rec["parsed"]
    chips = rec["num_devices"]
    compute_s = p["flops_per_device"] / HW.peak_flops_bf16
    memory_s = p["hbm_bytes_per_device"] / HW.hbm_bw
    coll_s = (
        p["ici_wire_bytes_per_chip"] / HW.nvlink_bw
        + p["dcn_wire_bytes_per_chip"] / HW.ib_bw_per_gpu
    )
    model_per_dev = rec["model_flops"] / chips
    useful = model_per_dev / max(p["flops_per_device"], 1.0)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = compute_s / bound if bound > 0 else 0.0
    hints = {
        "compute": "reduce recompute/masked-block waste (remat policy, "
                   "capacity padding); raise arithmetic intensity",
        "memory": "cut activation traffic: fused elementwise chains, "
                  "microbatching, chunked loss, flash tiles sized to shared memory",
        "collective": "reshard to shrink wire bytes: sequence-parallel "
                      "norms, cohort (hierarchical) exchange, int8 pod hop, "
                      "overlap via async collectives",
    }
    return {
        "cell": rec["cell"],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "roofline_fraction": frac,
        "useful_flops_ratio": useful,
        "model_flops_per_dev": model_per_dev,
        "hlo_flops_per_dev": p["flops_per_device"],
        "peak_bytes_per_dev": rec["memory_analysis"]["peak_estimate_bytes_per_device"],
        "fits_hbm": rec["memory_analysis"]["peak_estimate_bytes_per_device"]
        <= HW.hbm_bytes,
        "hint": hints[dominant],
    }


def load_all(results_dir: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if "skipped" in rec:
            out.append({"cell": rec["cell"], "skipped": rec["skipped"]})
            continue
        out.append(roofline_terms(rec))
    return out


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'cell':58s} {'compute':>9s} {'memory':>9s} {'coll':>9s} "
           f"{'dom':>10s} {'roofl%':>7s} {'useful%':>8s} {'HBM GB':>7s} fits")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if "skipped" in r:
            lines.append(f"{r['cell']:58s} SKIP: {r['skipped']}")
            continue
        lines.append(
            f"{r['cell']:58s} {r['compute_s']:9.3f} {r['memory_s']:9.3f} "
            f"{r['collective_s']:9.3f} {r['dominant']:>10s} "
            f"{100 * r['roofline_fraction']:6.1f}% "
            f"{100 * r['useful_flops_ratio']:7.1f}% "
            f"{r['peak_bytes_per_dev'] / 1e9:7.1f} "
            f"{'y' if r['fits_hbm'] else 'N'}"
        )
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    rows = load_all(args.results)
    print(format_table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
