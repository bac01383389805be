"""Writes ``regnet_ref/``, the reference's frozen copy of the port's plain
paths, from the port's sources:

    python3 portbench/reference/freeze.py

It copies the modules that the model, the losses, the trainer and the
weight loader need, renamed into this package, and then edits the copy:
every op takes its plain branch on every device (an ``x.device.type ==
"cpu"`` test becomes true and a ``== "cuda"`` one false, and the dead
branch is cut), keeping cuBLAS's bf16 product; train-mode BatchNorm
statistics are summed in f64 on the card, as the port's statistics kernel
sums them; ``Dense`` gains the control's operand rounding; the serving
funnels are refused and only npz weights are read; whatever nothing in the
copy then uses is pruned.  It reads the port's files and imports nothing
of it.  The copy is the yardstick: rerun this only in a change to the
benchmark.
"""

from __future__ import annotations

import ast
import os
import re
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "..", "regnet_for_3d_grasping_torch")
DST = os.path.join(HERE, "regnet_ref")
MODULES = ["config", "geometry/codec", "geometry/gt", "geometry/region",
           "models/backbone", "models/heads", "models/regnet",
           "models/score_net", "nn/layers", "ops/ball_query", "ops/crop",
           "ops/distances", "ops/fps", "ops/group", "ops/grouping",
           "ops/knn", "ops/pooling", "ops/sampling", "ops/slab",
           "ops/bucket_scan", "train/losses", "train/trainer", "weights",
           "runtime"]
PACKAGES = ["", "geometry", "models", "nn", "ops", "train"]
# what the harness calls by name; pruning keeps it
ENTRIES = {"infer_config", "train_config", "tiny_config", "load_into",
           "make_optimizer", "train_step", "device_batch", "REGNet",
           "round_operand", "CONTROL", "fallbacks"}

CUDA_BF16 = ('    if x.device.type == "cuda":\n        return F.linear(x, w)',
             '    if x.is_cuda:\n        return F.linear(x, w)')
STATS = ("""    axes = tuple(range(x.dim() - 1))
    xf = x.float() if x.dtype == torch.bfloat16 else x
    mean = xf.mean(axes)
    return mean, ((xf * xf).mean(axes) - mean * mean).clamp(min=0.0)""",
         """    axes = tuple(range(x.dim() - 1))
    if not x.is_cuda:
        # the port's plain version, which its CPU path runs
        xf = x.float() if x.dtype == torch.bfloat16 else x
        mean = xf.mean(axes)
        return mean, ((xf * xf).mean(axes) - mean * mean).clamp(min=0.0)
    # on the card in f64, as the port's statistics kernel sums
    xd = x.double()
    mean = xd.mean(axes)
    var = (xd * xd).mean(axes) - mean * mean
    return mean.float(), var.float().clamp(min=0.0)""")
CONTROL = ('''class Dense(nn.Linear):''',
           '''# the control's precision of the matrix products' operands: None (the
# configuration's), "tf32" (the f32 operands rounded to TF32's 10-bit
# mantissa) or "fp8" (the operands rounded to float8 e4m3)
CONTROL = None


def round_operand(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to the `CONTROL` precision, in `t`'s dtype."""
    if CONTROL is None:
        return t
    if CONTROL == "fp8":
        return t.to(torch.float8_e4m3fn).to(t.dtype)
    if CONTROL == "tf32":
        bits = t.float().contiguous().view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32).to(t.dtype)
    raise ValueError(f"unknown control precision {CONTROL!r}")


class Dense(nn.Linear):''')
DENSE = ('''        if self.compute == torch.float32:
            return F.linear(x, self.weight)
        return bf16_matmul(x, self.weight)''',
         '''        if self.compute == torch.float32:
            return F.linear(round_operand(x), round_operand(self.weight))
        return bf16_matmul(round_operand(x.to(torch.bfloat16)),
                           round_operand(self.weight.to(torch.bfloat16)))''')
KNOBS = ('''    if cfg.model.ball_query_method not in ("bucket", "exact"):''',
         '''    if r.pose_search_k > 0 or r.refine_guard:
        raise ValueError("the reference copies no serving funnel "
                         "(pose_search_k, refine_guard)")
    if cfg.model.ball_query_method not in ("bucket", "exact"):''')
CUDA_STUB = '''"""What the copied modules keep of the port's kernel loader: the count of
slab 3-NN fallbacks.  The reference launches no kernel: the copied modules
run their plain versions on every device."""

from collections import Counter

fallbacks = Counter()
fallbacks.add = lambda name: fallbacks.update([name])
'''
PACKAGE_DOC = '''"""A frozen copy of the plain paths of the port's model, losses, trainer
and weight loader: every op runs its plain PyTorch version on every device
(the copied kernel branches are cut out), so on the card it computes what
the kernels compute, with PyTorch's own operations.  Train-mode BatchNorm
statistics on the card are summed in f64, as the port's statistics kernel
sums them (on the CPU in f32, as the port's CPU path).
Imports nothing of the port or of JAX."""
'''


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def _replace(text: str, pair: tuple) -> str:
    old, new = pair
    if old not in text:
        raise ValueError(f"the port's source changed: {old.splitlines()[0]!r}")
    return text.replace(old, new, 1)


def copy_modules() -> None:
    """The modules, renamed, each op's kernel test made a constant."""
    if os.path.exists(DST):
        shutil.rmtree(DST)
    for m in MODULES:
        s = _read(os.path.join(SRC, f"{m}.py"))
        s = s.replace("regnet_for_3d_grasping_torch",
                      "portbench.reference.regnet_ref")
        s = s.replace(*CUDA_BF16)
        s = re.sub(r'[\w\.\[\]]+\.device\.type == "cpu"', "True", s)
        s = re.sub(r'[\w\.\[\]]+\.device\.type == "cuda"', "False", s)
        s = re.sub(r'[\w\.\[\]]+\.device\.type != "cpu"', "False", s)
        s = re.sub(r'\bdev\.type == "cpu"', "True", s)
        os.makedirs(os.path.dirname(os.path.join(DST, f"{m}.py")),
                    exist_ok=True)
        _write(os.path.join(DST, f"{m}.py"), s)
    for d in PACKAGES:
        p = os.path.join(DST, d, "__init__.py")
        if not os.path.exists(p):
            _write(p, "")


def _indent(line: str):
    return len(line) - len(line.lstrip(" ")) if line.strip() else None


def cut_constant_branches(path: str) -> None:
    """``if True:`` keeps its body (and, where the body returns, drops the
    rest of the enclosing block); ``if False:`` goes."""
    lines = _read(path).split("\n")
    out, i = [], 0
    while i < len(lines):
        line = lines[i]
        head = line.strip()
        if head not in ("if True:", "if False:"):
            out.append(line)
            i += 1
            continue
        ind = _indent(line)
        j, body = i + 1, []
        while j < len(lines) and (_indent(lines[j]) is None
                                  or _indent(lines[j]) > ind):
            body.append(lines[j])
            j += 1
        while body and not body[-1].strip():
            body.pop()
            j -= 1
        if head == "if True:":
            out.extend(b[4:] if b.strip() else b for b in body)
            base = [b.strip() for b in body if _indent(b) == ind + 4]
            last = base[-1] if base else ""
            if last.startswith(("return", "raise")):
                while j < len(lines) and (_indent(lines[j]) is None
                                          or _indent(lines[j]) >= ind):
                    j += 1
                out += ["", ""]
        i = j
    _write(path, "\n".join(out))


def edit_copy() -> None:
    """The statistics in f64, the control's rounding, the funnels refused,
    npz weights only, the kernel loader's stub and the package's doc."""
    lay = os.path.join(DST, "nn/layers.py")
    t = _read(lay).replace("from portbench.reference.regnet_ref.ops import "
                           "batch_norm as bn_kernels\n", "")
    for pair in (STATS, CONTROL, DENSE):
        t = _replace(t, pair)
    _write(lay, t)
    rp = os.path.join(DST, "models/regnet.py")
    t = _read(rp)
    for start, stop in (("        if region.pose_search_k > 0:",
                         "        proposals_sg = proposals.detach()"),
                        ("            if region.refine_guard:",
                         "            refine_accept = ((refine_logits")):
        t = t.replace(t[t.index(start):t.index(stop)], "")
    _write(rp, _replace(t, KNOBS))
    wp = os.path.join(DST, "weights.py")
    t = _read(wp)
    t = t.replace(t[t.index("    if isinstance(weights, (str, os.PathLike)) "
                            "and os.path.isdir(weights):"):
                    t.index("    elif isinstance(weights, (str, "
                            "os.PathLike)):")], "")
    t = t.replace("    elif isinstance(weights, (str, os.PathLike)):",
                  "    if isinstance(weights, (str, os.PathLike)):")
    _write(wp, t)
    _write(os.path.join(DST, "ops/_cuda.py"), CUDA_STUB)
    _write(os.path.join(DST, "__init__.py"), PACKAGE_DOC)


def prune(files: list) -> None:
    """Top-level functions and classes that nothing in the copy names
    (and no entry of `ENTRIES`), until none is left."""
    while True:
        texts = {p: _read(p) for p in files}
        names: dict = {}
        for s in texts.values():
            for n in ast.walk(ast.parse(s)):
                w = (n.id if isinstance(n, ast.Name) else
                     n.attr if isinstance(n, ast.Attribute) else
                     n.name if isinstance(n, ast.alias) else None)
                if w:
                    names[w] = names.get(w, 0) + 1
        removed = False
        for p, s in texts.items():
            lines = s.split("\n")
            cut = [(node.lineno - 1 - len(node.decorator_list),
                    node.end_lineno)
                   for node in ast.parse(s).body
                   if isinstance(node, (ast.FunctionDef, ast.ClassDef))
                   and node.name not in ENTRIES and not names.get(node.name)]
            if cut:
                for a, b in sorted(cut, reverse=True):
                    del lines[a:b]
                _write(p, re.sub(r"\n{4,}", "\n\n\n", "\n".join(lines)))
                removed = True
        if not removed:
            return


def drop_unused_imports(files: list) -> None:
    for p in files:
        s = _read(p)
        tree = ast.parse(s)
        used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        lines = s.split("\n")
        edits = []
        for node in tree.body:
            if not isinstance(node, (ast.Import, ast.ImportFrom)) or (
                    isinstance(node, ast.ImportFrom)
                    and node.module == "__future__"):
                continue
            names = [(a.asname or a.name).split(".")[0] for a in node.names]
            keep = [a for a, n in zip(node.names, names) if n in used]
            if len(keep) == len(names):
                continue
            repl = []
            if keep and isinstance(node, ast.ImportFrom):
                body = ", ".join(a.name + (f" as {a.asname}" if a.asname
                                           else "") for a in keep)
                line = f"from {node.module} import {body}"
                if len(line) > 79:
                    line = f"from {node.module} import (\n    {body})"
                repl = line.split("\n")
            edits.append((node.lineno - 1, node.end_lineno, repl))
        for a, b, repl in sorted(edits, reverse=True):
            lines[a:b] = repl
        _write(p, "\n".join(lines))


def main() -> None:
    copy_modules()
    files = [os.path.join(r, f) for r, _, fs in os.walk(DST) for f in fs
             if f.endswith(".py")]
    for p in files:
        cut_constant_branches(p)
    edit_copy()
    files = [os.path.join(r, f) for r, _, fs in os.walk(DST) for f in fs
             if f.endswith(".py")]
    prune(files)
    drop_unused_imports(files)


if __name__ == "__main__":
    main()
