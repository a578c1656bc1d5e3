"""A hybrid language model trained through the program's normal path: the
closed loop of ``lm_train`` (one trainer, each turn one ``train_step`` of
``launch.steps.build_train_step``), with weights made as the published
Zamba2 initialises them.

``lm_train.make_weights`` draws every leaf in bf16.  The program holds a
Mamba2 layer's ``A_log``, ``dt_bias`` and ``D_skip`` in fp32, and the
published initialisation sets them apart from the normal draw
(``Zamba2PreTrainedModel._init_weights``), so this driver makes the
weights itself, each leaf in the tree's own dtype, all from the seed:

* the configuration's ``init.std`` normal draw, in tree order from one
  generator, for every leaf that is not named below (every matrix, the
  embedding and the conv weights);
* 1 for the leaves named in ``init.ones`` (norm gains and ``D_skip``), 0
  for those in ``init.zeros`` (the conv bias);
* ``A_log`` = log(1 .. heads) in every layer;
* ``dt_bias`` = the inverse softplus of dt, dt log-uniform on
  [``time_step_min``, ``time_step_max``] (floored at ``time_step_floor``),
  drawn from the seed for every layer.

Everything else (the pool, the window, the plain reference the
configuration names) is ``lm_train``'s, whose ``Cell`` this one
subclasses.  The check adds one number to ``lm_train.numbers``':

* ``grad1_elem_gap``: by the worst leaf, the norm of the difference
  between the program's first gradient (clipped, from the optimizer's m
  after one step over 1 - b1) and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger.  Set-up
  keeps the program's first gradient on the host for it (fp32, 11 GB at
  the cell's size).

A norm by leaf barely moves with errors that are spread over a leaf's
elements (they add in quadrature), so ``grad1_leaf_gap`` cannot tell
the e4m3 control from the program at this cell's weights; the
difference itself can (``PERF.md`` §2).  ``controls`` is this module's:
these weights, this number, and the reference with bf16 products beside
the control as a witness of what bf16 rounding alone reads.
"""
from __future__ import annotations

import contextlib
import math
import statistics
import sys

from perfbench.drivers import lm_train


def make_weights(spec, cfg: dict, seed: int, device):
    """The program's parameter tree on ``device``, each leaf in its own
    dtype, made as the module's docstring says."""
    import torch
    from repro_torch import tree as T
    from repro_torch.models import api
    shapes = api.param_shapes(spec)
    pairs = T.leaves_with_paths(shapes)
    init = cfg["init"]
    ones, zeros = set(init["ones"]), set(init.get("zeros", ()))
    special = ones | zeros | {"A_log", "dt_bias"}
    drawn = [leaf.numel() for path, leaf in pairs if path[-1] not in special]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(drawn), dtype=torch.float32, device=device)
    flat.normal_(0.0, init["std"], generator=gen)
    lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
    out, at = [], 0
    for path, leaf in pairs:
        kw = dict(dtype=leaf.dtype, device=device)
        name = path[-1]
        if name in ones:
            out.append(torch.ones(leaf.shape, **kw))
        elif name in zeros:
            out.append(torch.zeros(leaf.shape, **kw))
        elif name == "A_log":
            heads = torch.arange(1, leaf.shape[-1] + 1, dtype=torch.float32,
                                 device=device)
            out.append(torch.log(heads).expand(leaf.shape).to(**kw))
        elif name == "dt_bias":
            u = torch.rand(leaf.shape, generator=gen, device=device)
            dt = torch.exp(u * (hi - lo) + lo).clamp(
                min=cfg["time_step_floor"])
            out.append((dt + torch.log(-torch.expm1(-dt))).to(**kw))
        else:
            out.append(flat[at:at + leaf.numel()].view(leaf.shape).to(**kw))
            at += leaf.numel()
    del flat
    return T.unflatten(shapes, out)


@contextlib.contextmanager
def _own_weights():
    """``lm_train``'s set-up and check with this module's weights."""
    was = lm_train.make_weights
    lm_train.make_weights = make_weights
    try:
        yield
    finally:
        lm_train.make_weights = was


@contextlib.contextmanager
def _first_gradient_kept(cell):
    """``lm_train``'s set-up with the first step's gradient kept:
    ``cell.grad1``, by the reference's leaves, fp32 on the host, read as
    ``lm_train`` reads its norms (the optimizer's m over 1 - b1).  The
    step ``lm_train`` builds is wrapped for its first call only."""
    from repro_torch.launch import steps
    build = steps.build_train_step
    b1 = cell.cfg["optimizer"]["b1"]

    def build_keeping(*args, **kw):
        step = build(*args, **kw)

        def first(params, state, batch):
            out = step(params, state, batch)
            R = lm_train.reference(cell.cfg)
            cell.grad1 = {k: (m / (1 - b1)).cpu()
                          for k, m in R.flatten(out[1]["m"]).items()}
            cell.step = step
            return out
        return first

    steps.build_train_step = build_keeping
    try:
        yield
    finally:
        steps.build_train_step = build


class Cell(lm_train.Cell):
    def setup(self) -> None:
        with _own_weights(), _first_gradient_kept(self):
            super().setup()

    def check(self):
        R = lm_train.reference(self.cfg)
        ref = R.train_steps(make_weights(self.spec, self.cfg, self.seed,
                                         self.device),
                            self.compared, self.cfg, against=self.grad1)
        del self.grad1
        got = numbers(self.program, ref, ref["grad1_diff"])
        for k in self.wl.get("not_compared", {}):
            print(f"perfbench: {k} {got[k]!r} (not compared)",
                  file=sys.stderr)
        return [(k, got[k], lim["limit"])
                for k, lim in self.wl["limits"].items()]


def numbers(side: dict, ref: dict, diff: dict) -> dict:
    """``lm_train.numbers`` of one side against the reference, and
    ``grad1_elem_gap`` from ``diff``, the norms by leaf of the difference
    of the two first gradients; the worst leaf goes to standard error."""
    out = lm_train.numbers(side, ref)
    med = statistics.median(ref["grad1"].values())
    gaps = {k: d / max(ref["grad1"][k], med) for k, d in diff.items()}
    worst = max(gaps, key=gaps.get)
    out["grad1_elem_gap"] = gaps[worst]
    print(f"perfbench: grad1 elementwise: worst leaf {worst} "
          f"{gaps[worst]!r}", file=sys.stderr)
    return out


def vector_rows(rows: dict, ref_key: str) -> dict:
    """The worst entry of the stacked one-vector leaves (a layer's
    ``D_skip``), each over its own reference norm: the gap of the norms
    (``row_norm_gap``, what a check by layer compares) and the norm of
    the difference (``row_elem_gap``).  ``ref_key`` names which of the
    two sides in ``rows`` is the reference."""
    other = "against" if ref_key == "own" else "own"
    norm_gap, elem_gap = {}, {}
    for n, r in rows.items():
        for i, (a, b, d) in enumerate(zip(r[ref_key], r[other], r["diff"])):
            norm_gap[f"{n}/{i}"] = abs(b - a) / a
            elem_gap[f"{n}/{i}"] = d / a
    worst = max(norm_gap, key=norm_gap.get)
    worst_e = max(elem_gap, key=elem_gap.get)
    return {"row_norm_gap": norm_gap[worst], "row_norm_gap_at": worst,
            "row_elem_gap": elem_gap[worst_e], "row_elem_gap_at": worst_e}


def controls(wl: dict, cfg: dict, seed: int) -> dict:
    """The program's numbers and, against the same fp32 reference, the
    control's (the reference with every weight product's inputs through
    e4m3 and the unembedding's through bf16), the bf16 witness's (the
    reference with every weight product's inputs through bf16) and two
    faults' read in the reference: half of each batch left out, and a
    step that returns the parameters unchanged.  The program, the control
    and the witness also read ``vector_rows``."""
    cell = Cell(wl, cfg, seed)
    cell.setup()
    prog, grad1 = cell.program, cell.grad1
    cell.release()
    del cell.grad1
    R = lm_train.reference(cfg)
    weights = make_weights(cell.spec, cfg, seed, cell.device)
    ref = R.train_steps(weights, cell.compared, cfg, against=grad1,
                        keep=True)
    del grad1
    full = ref.pop("grad1_full")
    out = {"program": dict(numbers(prog, ref, ref["grad1_diff"]),
                           **vector_rows(ref["grad1_rows"], "own"))}
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("witness_bf16", {"precision": "bf16"}),
                     ("fault_half_batch", {"half_batch": True})):
        side = R.train_steps(weights, cell.compared, cfg, against=full,
                             **kw)
        out[name] = numbers(side, ref, side["grad1_diff"])
        if "precision" in kw:
            out[name].update(vector_rows(side["grad1_rows"], "against"))
    still = dict(prog, change={k: 0.0 for k in prog["change"]})
    out["fault_state_unchanged"] = numbers(still, ref, ref["grad1_diff"])
    return out
