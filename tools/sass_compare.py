"""Compare the machine code (SASS) of the kernels of two copies of the
port's kernel sources:

    python3 tools/sass_compare.py <csrc dir a> [<csrc dir b>] [--files f,..]
                                  [--kept f,..]

<csrc dir b> defaults to this tree's `src/repro_torch/kernels/csrc`;
`--files` names the sources whose kernels must be the same on both sides
(default: none); `--kept` names the sources where every kernel of <a>
must be in <b> unchanged, and <b> may add kernels (default: `ssd_scan`,
which keeps its float32-core schedule's four instantiations beside the
tensor-core kernel, and `stencil_tb`, `stencil_tb_elastic` and
`stencil_tb_tti`, which keep their first schedule beside the z-streamed
one).  Each source is compiled to a cubin
with the port's nvcc flags (under `build/sass/`) and disassembled
with `cuobjdump -sass`; every kernel function (each template
instantiation, by its mangled name) is compared instruction by
instruction (with its encoding) with the code offsets and the column
padding stripped and the branch labels numbered within the function.  Prints, per file, how many
functions are identical, and exits 1 if any differs or is missing where
it must not be.  Needs the CUDA toolkit (nvcc, cuobjdump), not a card.
"""
import argparse
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

FILES = ()
KEPT = ("ssd_scan", "stencil_tb", "stencil_tb_elastic", "stencil_tb_tti")
OFFSET = re.compile(r"^\s*/\*[0-9a-f]+\*/")      # an instruction's offset
LABEL = re.compile(r"\.L_x_\d+")                 # a branch target's label


def _local_labels(lines):
    """The lines with their branch labels renumbered in order of first
    appearance: cuobjdump numbers them across the whole file (and pads its
    columns to the file's widest line), so a kernel added beside another
    changes the other's listing but not its code."""
    names = {}
    return [LABEL.sub(lambda m: names.setdefault(m.group(0),
                                                 f".L_{len(names)}"), ln)
            for ln in lines]


def functions(src: Path, tag: str):
    """{mangled name: [instruction, ...]} of the kernels compiled from
    `src`."""
    out = _build.BUILD_DIR.parent / "sass"
    out.mkdir(parents=True, exist_ok=True)
    cubin = out / f"{tag}.cubin"
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([_build.nvcc(), *flags, "-cubin", "-o", str(cubin),
                    str(src)], check=True, capture_output=True)
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    funcs = {}
    for block in text.split("Function : ")[1:]:
        lines = block.splitlines()
        funcs[lines[0].strip()] = _local_labels(
            [" ".join(OFFSET.sub("", ln).split()) for ln in lines[1:]
             if ln.strip().startswith("/*")])
    return funcs


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b", nargs="?", default=str(_build.CSRC))
    ap.add_argument("--files", default=",".join(FILES))
    ap.add_argument("--kept", default=",".join(KEPT))
    args = ap.parse_args(argv)
    dirs = [Path(args.a), Path(args.b)]
    ok = True
    for kept, names in ((False, args.files), (True, args.kept)):
        for f in filter(None, names.split(",")):
            a, b = (functions(d / f"{f}.cu", f"{f}-{i}")
                    for i, d in enumerate(dirs))
            same = sum(a[k] == b.get(k) for k in a)
            ok = ok and same == len(a) and (kept or len(a) == len(b))
            for k in a:
                if a[k] != b.get(k):          # the first difference
                    diff = next(((i, x, y) for i, (x, y) in enumerate(
                        zip(a[k], b.get(k, []))) if x != y),
                        (None, len(a[k]), len(b.get(k, []))))
                    print(f"  {k}: {'missing' if k not in b else diff}",
                          flush=True)
                    break
            print(f"{f}: {len(a)} kernel functions in {dirs[0]}, {len(b)} "
                  f"in {dirs[1]}; {'of the first, ' if kept else ''}"
                  f"identical SASS: {same}/{len(a)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
