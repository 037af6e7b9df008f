"""What limits the draw kernels on one NVIDIA card: each kernel of a tree's
`ops/csrc/threefry_gumbel.cu` timed as it is and with one part of its work
taken out, at the main path's shapes; and the categorical kernel's
instructions counted by pipe from its SASS (no profiler is needed).

    python3 scripts/torch_draw_ablation.py [--tree DIR ...] [--set NAME=VALUE ...]

Each tree (this one by default; another, e.g. a `git archive` of the parent
commit unpacked into a gitignored directory, by --tree) has its source
copied three times into a temporary directory and built with
`ops/build.py`'s nvcc flags:
  full   the source as it is;
  hash   the logs taken out: the Gumbel value is the uniform itself (the
         20-round threefry hash, the uniform and, in the categorical
         kernel, the add and the running maximum stay; a source whose
         logs run N-wide, `log_f32_n`, has each call made a copy);
  logs   the hash taken out: `threefry` is one multiply-add and one xor
         (the two float64 logs and everything after them stay);
  floor  both taken out: the launch, the keys, the table, the loop, the
         maximum and the store;
  nofold the floor with the keys' fold chains taken out (each field's key
         is its base key);
  empty  the categorical kernel returns at once: the launch alone;
and, for a source whose logs run N-wide (`log_f32_n`):
  table  the log's table lookup taken out (both entries read from r);
  convert  its float64 conversions (the float32 input, the float32
         result, the exponent where it is converted) made bit moves.
Each library's C entry points are called with ctypes on the card: the
field kernel (`threefry_gumbel`, where the source has it: a tree before
the categorical kernel) at one frame's main and rescue fields, 4 x 512 x
768, and the categorical kernel (`threefry_categorical`, where the source
has it) at one solve's draws, 2 x 512 of 768, timed as the replay of
a CUDA graph of 100 calls (the device's time per call), in turns (the
variants in order, then in reverse). If the hash and the logs issued side by side
(separate pipes, both busy), full would be near the larger of hash and
logs; if they do not overlap, near their sum. Also prints ptxas's
registers per kernel of each build, and for the full and floor builds of
the categorical kernel its SASS instructions (`cuobjdump -sass`) by
opcode and by pipe (integer, float64, float32, memory, other): the loop
body's per value, (full - floor) / kChains, is the issue work a value
costs beside the bound's 75. --set NAME=VALUE rewrites the
source's `constexpr int NAME = ...;` first (a tree whose source has no such
constant fails), to compare its design constants in one call. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, M, KEYS_INDEX = 512, 768, 3


def _fail(msg: str) -> None:
    print(f"torch_draw_ablation: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def variants(text: str) -> dict:
    """The three sources of one threefry_gumbel.cu."""
    scalar = re.compile(r"return -log_f32\(-log_f32\(u(, table)?\)(, table)?\);")
    wide = re.compile(r"log_f32_n\((\w+), (\w+), table\);")
    hash_fn = re.compile(r"(void threefry\(uint32_t k1, uint32_t k2, uint32_t& x1, "
                         r"uint32_t& x2[^)]*\) \{)(.*?)(\n\})", re.S)
    if (len(scalar.findall(text)), len(wide.findall(text))) not in ((1, 0), (0, 2)) or \
            len(hash_fn.findall(text)) != 1:
        _fail("the source's Gumbel step or threefry no longer matches this script's anchors")
    no_logs = scalar.sub("return u;", wide.sub(
        lambda m: f"for (int k = 0; k < N; ++k) {m.group(2)}[k] = {m.group(1)}[k];", text))
    def no_hash(t):
        return hash_fn.sub(lambda m: m.group(1) + "\n  x1 = x2 * 0x9E3779B9u + k1; "
                           "x2 ^= x1 + k2;" + m.group(3), t)

    out = {"full": text, "hash": no_logs, "logs": no_hash(text), "floor": no_hash(no_logs)}
    fold = re.compile(r"(void field_key\([^)]*\) \{.*?k2 = static_cast<uint32_t>\(keys\[2 \* "
                      r"p_key \+ 1\]\);)\n  for \(int l = -1; l < paths.len; \+\+l\) \{", re.S)
    entry = re.compile(r"(threefry_categorical_kernel\([^)]*\) \{)")
    if len(fold.findall(text)) == 1 and len(entry.findall(text)) == 1:
        out["nofold"] = fold.sub(lambda m: m.group(1) + "\n  for (int l = -1; l < -1; ++l) {",
                                 out["floor"])
        out["empty"] = entry.sub(lambda m: m.group(1) + "\n  if (d.M > 0) return;", text)
    lookup = re.compile(r"t\[k\] = \w+\[j\[k\][^;]*\];")
    if len(lookup.findall(text)) == 1 and "#include <cuda_runtime.h>\n" in text:
        # The N-wide log's table lookup, and its float64 conversions.
        out["table"] = lookup.sub("t[k] = make_double2(r[k], r[k]);", text)
        out["convert"] = text.replace(
            "#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n#define __double2float_rn(v) "
            "__int_as_float(__double2hiint(v))\n").replace(
            "static_cast<double>(x[k])", "__hiloint2double(__float_as_int(x[k]), 0)").replace(
            "static_cast<double>(e[k])", "__hiloint2double(e[k], 0)")
    return out


def build(tree: str, workdir: str, settings) -> dict:
    """variant -> (loaded library, ptxas report, path) of the tree's source with
    `settings` (NAME=VALUE) applied."""
    sys.path.insert(0, ROOT)
    from vislam_tpu_torch.ops import build as b

    src = os.path.join(tree, "vislam_tpu_torch", "ops", "csrc", "threefry_gumbel.cu")
    with open(src) as f:
        text = f.read()
    for item in settings:
        name, value = item.split("=")
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{value};", text)
        if n != 1:
            _fail(f"{src} has no constexpr int {name}")
    csrc = os.path.dirname(src)
    jobs = {}
    for name, body in variants(text).items():
        d = os.path.join(workdir, name)
        os.makedirs(d)
        for h in os.listdir(csrc):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, h), d)
        with open(os.path.join(d, "threefry_gumbel.cu"), "w") as f:
            f.write(body)
        out = os.path.join(d, "lib.so")
        jobs[name] = (out, subprocess.Popen(
            [b.nvcc_path(), *b.NVCC_FLAGS, "-o", out, os.path.join(d, "threefry_gumbel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            _fail(f"nvcc failed on the {name} variant of {src}:\n{err[-3000:]}")
        regs = re.findall(r"Compiling entry function '_Z\w*?(threefry_\w+?_kernel)\w*'.*?"
                          r"Used (\d+) registers", err, re.S)
        libs[name] = (ctypes.CDLL(out), regs, out)
    return libs


PIPES = {
    "float64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"),
    "float32": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FSET", "MUFU", "FCHK"),
    "memory": ("LDG", "STG", "LDS", "STS", "LDC", "LD", "ST", "LDL", "STL", "ATOMS", "RED"),
    "integer": ("IADD3", "IMAD", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IMNMX", "IABS",
                "FLO", "POPC", "MOV", "SGXT", "BMSK", "VIADD", "VIMNMX", "P2R", "R2P", "PLOP3",
                "IADD", "IMUL", "LEA.HI"),
}


def _pipe(op: str, full: str) -> str:
    if op in ("F2F", "I2F", "F2I") and ".F64" in full:
        return "float64"
    if op.startswith("U"):
        return "uniform"
    return next((pipe for pipe, ops in PIPES.items() if op in ops), "other")


def sass_loop(lib_path: str, kernel: str) -> dict:
    """The SASS of `kernel` in a built library (`cuobjdump -sass`): its
    instructions by pipe, and those of its longest loop (the span from a
    label to the last branch back to it) by pipe and by opcode, with the
    loop's hash rotations (`SHF.L.W`, 20 a value)."""
    from vislam_tpu_torch.ops import build as b

    tool = os.path.join(os.path.dirname(b.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120).stdout
    body = next((f for f in text.split("Function : ")[1:] if kernel in f.split("\n")[0]), "")
    ins, labels, branches = [], {}, []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(ins)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);", line)
        if not m:
            continue
        labels.setdefault(int(m.group(1), 16), len(ins))
        op = m.group(2).split(".")[0]
        # A branch's target: a label (nvdisasm) or an address (cuobjdump).
        target = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", m.group(3))
        if op == "BRA" and target:
            branches.append((target.group(1) or int(target.group(2), 16), len(ins)))
        ins.append((op, m.group(2), _pipe(op, m.group(2) + m.group(3))))
    spans = [(labels[t], i) for t, i in branches if t in labels and labels[t] < i]
    lo, hi = max(spans, key=lambda s: s[1] - s[0], default=(0, -1))
    loop = ins[lo:hi + 1]

    def by_pipe(xs):
        out = {}
        for _, _, pipe in xs:
            out[pipe] = out.get(pipe, 0) + 1
        return out

    ops = {}
    for op, _, _ in loop:
        ops[op] = ops.get(op, 0) + 1
    return {"kernel": by_pipe(ins), "loop": by_pipe(loop), "loop_ops": ops,
            "loop_rotations": sum(1 for _, full, _ in loop if full.startswith("SHF.L.W"))}


def graph_us(fn, calls: int = 100, replays: int = 5) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays) * 1e3


def calls(lib) -> dict:
    """kernel -> a call of the library's entry point at the main shapes."""
    import torch

    i, p = ctypes.c_int, ctypes.c_void_p
    keys = torch.tensor([[0, 0]], dtype=torch.int32, device="cuda")
    index = torch.tensor([KEYS_INDEX], dtype=torch.int32, device="cuda")
    fields = torch.empty((1, 4, H, M), dtype=torch.float32, device="cuda")
    paths4 = (ctypes.c_int * 8)(0, -1, 1, -1, 7, 0, 7, 1)

    def stream():          # the capturing stream inside a graph capture
        return torch.cuda.current_stream().cuda_stream

    out = {}
    if hasattr(lib, "threefry_gumbel"):
        gum = lib.threefry_gumbel
        gum.argtypes = [p, p, i, i, i, p, i, p, p]
        gum.restype = ctypes.c_int
        out["threefry_gumbel 4 x 512 x 768"] = lambda: gum(
            keys.data_ptr(), index.data_ptr(), 1, 4, 2, paths4, H * M, fields.data_ptr(),
            stream())
    if hasattr(lib, "threefry_categorical"):
        cat = lib.threefry_categorical
        cat.argtypes = [p, i, p, i, p, i, i, i, i, p, i, i, p, p]
        cat.restype = ctypes.c_int
        g = torch.Generator().manual_seed(0)
        logits = torch.log((torch.rand(1, M, generator=g) < 0.4).float() + 1e-9).cuda()
        idx = torch.empty((1, 2, H), dtype=torch.int64, device="cuda")
        paths2 = (ctypes.c_int * 2)(0, 1)
        out["threefry_categorical 2 x 512 of 768"] = lambda: cat(
            keys.data_ptr(), 1, index.data_ptr(), 1, logits.data_ptr(), 1, 1, 2, 1, paths2, H, M,
            idx.data_ptr(), stream())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="a tree of the repository (repeatable; "
                                                    "default: this one)")
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=VALUE: a constexpr int of the source (repeatable)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    summary = {"card": card, "set": args.set, "trees": {}}
    for tree in args.tree or [ROOT]:
        with tempfile.TemporaryDirectory() as work:
            libs = build(os.path.abspath(tree), work, args.set)
            fns = {name: calls(lib) for name, (lib, _, _) in libs.items()}
            for name, (_, regs, _) in libs.items():
                print(f"ablation {tree} {name}: registers {regs}", flush=True)
            res = {}
            if "threefry_categorical" in " ".join(fns["full"]):
                sass = {v: sass_loop(libs[v][2], "threefry_categorical_kernel")
                        for v in ("full", "floor")}
                per = {pipe: (n - sass["floor"]["loop"].get(pipe, 0))
                       for pipe, n in sass["full"]["loop"].items()}
                values = sass["full"]["loop_rotations"] / 20
                print(f"ablation {tree} categorical SASS: full {json.dumps(sass['full'])}; "
                      f"floor {json.dumps(sass['floor'])}; the full loop holds "
                      f"{values:g} values a lane (its rotations / 20), per value over the "
                      f"floor's loop "
                      f"{json.dumps({k: round(v / max(values, 1), 2) for k, v in per.items()})}",
                      flush=True)
                res["sass"] = sass
            for kernel in fns["full"]:
                have = [v for v in fns if kernel in fns[v]]
                turns = {v: [] for v in have}
                for v in have + have[::-1]:
                    fn = fns[v][kernel]
                    if fn() != 0:
                        _fail(f"{tree} {v} {kernel}: the launch failed")
                    turns[v].append(graph_us(fn))
                us = {v: sum(t) / len(t) for v, t in turns.items()}
                res[kernel] = dict(us=us, turns=turns)
                extra = "".join(f", without the {v} {us[v]:.2f} us" for v in us
                                if v not in ("full", "hash", "logs", "floor"))
                print(f"ablation {tree} {kernel}: graph full {us['full']:.2f} us, hash only "
                      f"{us['hash']:.2f} us, logs only {us['logs']:.2f} us (sum "
                      f"{us['hash'] + us['logs']:.2f}, max {max(us['hash'], us['logs']):.2f}), "
                      f"floor {us['floor']:.2f} us"
                      f"{extra}; turns "
                      f"{json.dumps({v: [round(x, 2) for x in t] for v, t in turns.items()})}",
                      flush=True)
        summary["trees"][tree] = res
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
