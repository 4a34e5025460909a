"""Compare the machine code (SASS) of the float32 TB kernel instantiations
of two copies of the port's kernel sources:

    python3 tools/sass_compare.py <csrc dir a> [<csrc dir b>]

<csrc dir b> defaults to this tree's `src/repro_torch/kernels/csrc`.  Each
of `stencil_tb.cu`, `stencil_tb_tti.cu` and `stencil_tb_elastic.cu` is
compiled to a cubin with the port's nvcc flags (under `build/sass/`) and
disassembled with `cuobjdump -sass`; instantiations are matched by their
(radius, DOM) template arguments, bf16 ones are skipped, and each pair's
instructions are compared with the code offsets stripped.  Prints, per
file, how many of the float32 instantiations are identical, and exits 1 if
any differs.  Needs the CUDA toolkit (nvcc, cuobjdump), not a card.
"""
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

FILES = ("stencil_tb", "stencil_tb_tti", "stencil_tb_elastic")
# the (radius, DOM) arguments of a kernel's mangled name, e.g.
# _Z18tb_acoustic_kernelILi2ELb0EEv... or ..ILi2ELb0EfEv.. (storage float)
ARGS = re.compile(r"_kernelILi(\d+)ELb([01])E")
OFFSET = re.compile(r"^\s*/\*[0-9a-f]+\*/")      # an instruction's offset


def instantiations(src: Path, tag: str):
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
        name = block.splitlines()[0].strip()
        m = ARGS.search(name)
        if m is None or "bfloat16" in name:
            continue
        funcs[m.groups()] = [OFFSET.sub("", ln).strip()
                             for ln in block.splitlines()[1:]
                             if ln.strip().startswith("/*")]
    return funcs


def main(argv):
    dirs = [Path(argv[0]), Path(argv[1]) if len(argv) > 1 else _build.CSRC]
    ok = True
    for f in FILES:
        a, b = (instantiations(d / f"{f}.cu", f"{f}-{i}")
                for i, d in enumerate(dirs))
        same = sum(a[k] == b.get(k) for k in a)
        ok = ok and same == len(a) == len(b)
        print(f"{f}: {len(a)} float32 instantiations in {dirs[0]}, "
              f"{len(b)} in {dirs[1]}; identical SASS: {same}/{len(a)}",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
