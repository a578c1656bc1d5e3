"""A language model trained through the program's normal path: a closed
loop of one trainer whose every turn is one ``train_step`` of
``launch.steps.build_train_step`` (loss, gradients, AdamW, under
``deterministic()``) on one batch.

Generic over the program's LM configurations: the configuration file
names the program's architecture and the widths it must have
(``"program"``), the optimizer, the initialisation, and its plain
reference (``reference/<name>.py``, which gives ``train_steps``); the
cell's file gives the batch, the sequence length, the pool, the steps
compared and each limit with its reason.

Inputs, all from the seed: the weights, made on the device by one
generator in one normal draw (the norm gains 1), in bf16 as the program
holds them; token ids uniform over the vocabulary, a pool of batches
drawn at set-up and cycled, documents packed without masks, each label
the next token.

Set-up builds the train step, the weights and the optimizer state, and
drives them through the configuration's first ``compared_steps`` steps
on the pool's first batches (rows that all differ), through the call the
window makes; the same state goes on into the window.  Those steps warm
up the step's one shape, and what they produced is kept for the check:
each step's loss, the first step's gradient norm, the first gradient by
leaf as the optimizer took it (its m after one step over 1 - b1), and
the change of the stored parameters over the steps by leaf.

The check, once the window has closed and the program's state is freed:
the plain reference follows the same steps from the same weights and
batches in fp32, and the numbers the cell's file names under
``"limits"`` are compared, each with its limit and the readings it was
set from (``PERF.md`` §2); those under ``"not_compared"`` are printed:

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_norm_gap``: the relative gap of the first gradient's global norm;
* ``grad1_leaf_gap`` and ``change_leaf_gap``: by the worst leaf (a layer's
  weight is a leaf), the gap between the program's and the reference's
  norms of the first gradient and of the parameters' change, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger.  Leaves whose first gradient in the reference is under a
  thousandth of the median leaf's move by round-off alone and are left
  out of the change.
"""
from __future__ import annotations

import importlib
import os
import statistics
import sys
import time

from perfbench import counts, harness as H


def reference(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def program_spec(cfg: dict):
    """The program's architecture, refused where a width or setting
    differs from what the configuration file states."""
    from repro_torch import configs
    spec = configs.get(cfg["program"]["arch"])
    for key, want in cfg["program"]["expect"].items():
        got = getattr(spec.cfg, key)
        if got != want:
            raise SystemExit(f"perfbench: the program's {spec.name} has "
                             f"{key} = {got!r}, the configuration {want!r}")
    return spec


def make_weights(spec, cfg: dict, seed: int, device):
    """The program's parameter tree, bf16 on ``device``: every leaf one
    normal draw of the configuration's ``init.std`` from one generator,
    in tree order, but the leaves named in ``init.ones``, which are 1."""
    import torch
    from repro_torch import tree as T
    from repro_torch.models import api
    shapes = api.param_shapes(spec)
    pairs = T.leaves_with_paths(shapes)
    ones = set(cfg["init"]["ones"])
    drawn = [leaf.numel() for path, leaf in pairs if path[-1] not in ones]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(drawn), dtype=torch.bfloat16, device=device)
    flat.normal_(0.0, cfg["init"]["std"], generator=gen)
    out, at = [], 0
    for path, leaf in pairs:
        if path[-1] in ones:
            out.append(torch.ones(leaf.shape, dtype=leaf.dtype,
                                  device=device))
        else:
            out.append(flat[at:at + leaf.numel()].view(leaf.shape))
            at += leaf.numel()
    return T.unflatten(shapes, out)


def make_pool(cfg: dict, wl: dict, seed: int, device) -> list:
    """``wl["pool"]`` batches of ``{"tokens", "labels"}``, (batch, seq)
    int32: ids uniform over the vocabulary, each label the next id."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    ids = torch.randint(0, cfg["vocab_size"],
                        (wl["pool"], wl["batch"], wl["seq"] + 1),
                        generator=gen, device=device, dtype=torch.int32)
    return [{"tokens": ids[j, :, :-1].contiguous(),
             "labels": ids[j, :, 1:].contiguous()}
            for j in range(wl["pool"])]


class Cell(H.ClosedLoopCell):
    def setup(self) -> None:
        # cuBLAS is deterministic only with a workspace set before its
        # first call (the step runs under deterministic algorithms); the
        # step's fp32 logits and their gradient (9.3 GiB each at 4 x 4096
        # over 151936 words) do not find room among the default
        # allocator's fixed segments, so they grow in place
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        t0 = time.perf_counter()
        import torch
        from repro_torch.launch.steps import build_train_step
        from repro_torch.optim import OptConfig, opt_init
        self.device = torch.device(H.DEVICE)
        self.spec = program_spec(self.cfg)
        opt = self.cfg["optimizer"]
        self.opt_cfg = OptConfig(**opt)
        self.step = build_train_step(self.spec, self.opt_cfg)
        self.pool = make_pool(self.cfg, self.wl, self.seed, self.device)
        n = self.wl["compared_steps"]
        self.compared = [(b["tokens"], b["labels"]) for b in self.pool[:n]]
        R = reference(self.cfg)
        start = make_weights(self.spec, self.cfg, self.seed, self.device)
        params, state = start, opt_init(start, self.opt_cfg)
        H.sync()
        marks = [time.perf_counter()]
        losses = []
        for t in range(n):
            params, state, stats = self.step(params, state, self.pool[t])
            losses.append(stats["loss"])
            if t == 0:
                grad_norm = float(stats["grad_norm"])
                grad1 = R.leaf_norms({k: m / (1 - opt["b1"]) for k, m in
                                      R.flatten(state["m"]).items()})
            H.sync()
            marks.append(time.perf_counter())
        steps = ", ".join(f"{b - a:.2f}" for a, b in zip(marks, marks[1:]))
        print(f"perfbench: set-up: imports, weights, pool and state "
              f"{marks[0] - t0:.2f} s; compared steps {steps} s",
              file=sys.stderr)
        old = R.flatten(start)
        change = R.leaf_norms({k: p.float() - old[k].float()
                               for k, p in R.flatten(params).items()})
        self.program = {"losses": [float(x) for x in losses],
                        "grad_norm": grad_norm, "grad1": grad1,
                        "change": change}
        del start, old
        self.params, self.state = params, state
        self.i = n

    def turn(self) -> None:
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        self.params, self.state, _ = self.step(self.params, self.state,
                                               batch)

    def rates(self, turns: int, window_s: float) -> dict:
        tokens = turns * self.wl["batch"] * self.wl["seq"]
        return {"train_tokens_per_s": tokens / window_s}

    def facts(self) -> dict:
        """What the readers count from shapes: a dense decoder's step
        FLOPs and one flash forward's and backward's work; nothing for
        another family, whose readers count from its own configuration."""
        c, B, S = self.cfg, self.wl["batch"], self.wl["seq"]
        if c["family"] != "dense":
            return {}
        shape = (B, S, c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"], "bf16")
        return {"step_flops": counts.dense_lm_train_flops(c, B, S),
                "flash_fwd": counts.flash_fwd_work(*shape),
                "flash_bwd": counts.flash_bwd_work(*shape)}

    def release(self) -> None:
        del self.params, self.state, self.pool

    def check(self):
        R = reference(self.cfg)
        ref = R.train_steps(make_weights(self.spec, self.cfg, self.seed,
                                         self.device),
                            self.compared, self.cfg)
        got = numbers(self.program, ref)
        for k in self.wl.get("not_compared", {}):
            print(f"perfbench: {k} {got[k]!r} (not compared)",
                  file=sys.stderr)
        return [(k, got[k], lim["limit"])
                for k, lim in self.wl["limits"].items()]


def numbers(side: dict, ref: dict) -> dict:
    """The four numbers the check compares, of one side (the program, the
    control or a fault) against the reference; the worst leaves go to
    standard error."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(side["losses"], ref["losses"]))
    med = statistics.median(ref["grad1"].values())
    moved = [k for k, g in ref["grad1"].items() if g >= 1e-3 * med]
    out = {"loss_gap": loss_gap,
           "grad_norm_gap": abs(side["grad_norm"] - ref["grad_norm"]) /
           ref["grad_norm"]}
    for key, leaves in (("grad1", list(ref["grad1"])), ("change", moved)):
        gaps = leaf_gaps(side[key], ref[key], leaves)
        worst = max(gaps, key=gaps.get)
        out[f"{key}_leaf_gap"] = gaps[worst]
        print(f"perfbench: {key}: worst leaf {worst} {gaps[worst]!r} "
              f"({side[key][worst]!r} against {ref[key][worst]!r}); "
              f"{len(ref[key]) - len(leaves)} leaves left out",
              file=sys.stderr)
    return out


def leaf_gaps(side: dict, ref: dict, leaves) -> dict:
    """|norm - reference norm| over the larger of the reference's norm of
    the leaf and of the median leaf, by leaf."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(side[k] - ref[k]) / max(ref[k], med) for k in leaves}


def controls(wl: dict, cfg: dict, seed: int) -> dict:
    """The program's numbers and, against the same fp32 reference, the
    control's (the reference with every weight product's inputs through
    e4m3 and the unembedding's through bf16) and two faults' read in
    the reference: half of each batch left out, and a step that returns
    the parameters unchanged (no change at all)."""
    cell = Cell(wl, cfg, seed)
    cell.setup()
    prog = cell.program
    cell.release()
    R = reference(cfg)
    weights = make_weights(cell.spec, cfg, seed, cell.device)
    ref = R.train_steps(weights, cell.compared, cfg)
    ctl = R.train_steps(weights, cell.compared, cfg, precision="fp8")
    half = R.train_steps(weights, cell.compared, cfg, half_batch=True)
    still = dict(prog, change={k: 0.0 for k in prog["change"]})
    return {"program": numbers(prog, ref), "control_fp8": numbers(ctl, ref),
            "fault_half_batch": numbers(half, ref),
            "fault_state_unchanged": numbers(still, ref)}
