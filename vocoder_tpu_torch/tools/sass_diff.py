"""Compare the machine code (SASS) of the kernel sources in two source trees, kernel by kernel.

    python -m vocoder_tpu_torch.tools.sass_diff DIR_A DIR_B   # needs nvcc; no card; exit 0 when all match

Compiles each ``*.cu`` of DIR_B that DIR_A also has, in both trees, each beside
its own headers, with the flags of ``ops/build.py``, disassembles them with
``cuobjdump -sass``, matches the kernels by name (the anonymous namespace's
tag, which differs between files, left out) and prints one JSON line per
kernel, then a summary line per source: instruction counts, and how many
instruction lines differ between A and B.  Identical SASS means that the two
trees compile to the same program, whatever their sources look like.  Use it
to show that a change to shared code leaves a kernel as it was (for example,
DIR_A an earlier commit's ``csrc`` unpacked into a git-ignored directory,
DIR_B ``vocoder_tpu_torch/csrc``).
"""

from __future__ import annotations

import argparse
import difflib
import json
import re
import subprocess
import sys
from pathlib import Path

from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.tools.timing import build_variants

# The anonymous namespace's mangled tag: _ZN<length>_GLOBAL__N__<hash>_<length>_<file>_cu_<hash>.
_ANON = re.compile(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*(/\*.*)?$")


def parse_sass(text: str) -> dict[str, list[str]]:
    """Kernel name -> its instructions, from ``cuobjdump -sass`` output, without addresses and encodings."""
    kernels, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _ANON.sub("_ZN", m.group(1))
            kernels[cur] = []
            continue
        m = _INSTRUCTION.match(line)
        if cur is not None and m:
            kernels[cur].append(m.group(1))
    return kernels


def sass(lib: str) -> dict[str, list[str]]:
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    return parse_sass(subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True, check=True).stdout)


def differing_lines(a: list[str], b: list[str]) -> int:
    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    return sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops if tag != "equal")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="compare the kernel sources' SASS in two trees")
    ap.add_argument("dir_a", type=Path)
    ap.add_argument("dir_b", type=Path)
    args = ap.parse_args(argv)
    stems = sorted(p.stem for p in args.dir_b.glob("*.cu") if (args.dir_a / p.name).is_file())
    jobs = {f"{side}_{stem}": ((d / f"{stem}.cu").read_text(), d.resolve())
            for stem in stems for side, d in (("a", args.dir_a), ("b", args.dir_b))}
    libs = build_variants("sass_diff", jobs)
    same = True
    for stem in stems:
        ka, kb = sass(libs[f"a_{stem}"]), sass(libs[f"b_{stem}"])
        identical = 0
        for name in sorted(set(ka) | set(kb)):
            a, b = ka.get(name), kb.get(name)
            diff = None if a is None or b is None else differing_lines(a, b)
            identical += diff == 0
            print(json.dumps({"source": stem, "kernel": name, "instructions_a": len(a or []),
                              "instructions_b": len(b or []), "differing_lines": diff}), flush=True)
        print(json.dumps({"source": stem, "dir_a": str(args.dir_a), "dir_b": str(args.dir_b), "kernels_a": len(ka),
                          "kernels_b": len(kb), "identical": identical, "instructions_a": sum(map(len, ka.values())),
                          "instructions_b": sum(map(len, kb.values()))}), flush=True)
        same = same and identical == len(ka) == len(kb)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
