"""Compare the SASS of kernel sources between another copy of csrc/ and this
package's.

    python -m threedhumangan_tpu_torch.apps.sass_diff OTHER_CSRC [SOURCE ...]
        [--rename OLD=NEW ...]

compiles each SOURCE (default: synthesis.cu, synthesis_train_bwd.cu and
raymarch.cu, the kernels on K3's core besides K10) from OTHER_CSRC and from
this package's csrc/, each copied to the same scratch path, with
``_build.NVCC_FLAGS`` into a cubin; disassembles both with ``cuobjdump
-sass``; replaces the names nvcc gives anonymous namespaces (they carry
hashes) by one token; and prints one JSON line a source: the instructions of
each function on both sides and the instruction lines that differ over the
whole listings (addresses left out).  ``--rename OLD=NEW`` reads
OTHER_CSRC's function names with OLD replaced by NEW, so a kernel that was
only renamed (a template's name or its arguments' kinds) is compared with
itself.  Needs the CUDA toolkit (nvcc, cuobjdump); exits 1 if any line
differs.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from threedhumangan_tpu_torch import _build

SOURCES = ("synthesis.cu", "synthesis_train_bwd.cu", "raymarch.cu")
_ANON = re.compile(r"\d+_GLOBAL__N__\w+?_\d+_\w+?_cu_[0-9a-f]{8}")
_INSN = re.compile(r"/\*[0-9a-f]+\*/\s+(.*?)\s*;")


def listing(csrc: str, source: str, scratch: str) -> dict:
    """{function: [instruction, ...]} of one source compiled from ``csrc``."""
    work = os.path.join(scratch, "csrc")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work)
    cubin = os.path.join(scratch, "k.cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", cubin, os.path.join(work, source)],
                   check=True, capture_output=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        line = _ANON.sub("ANON", line)
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                funcs[name].append(m.group(1))
    return funcs


def rename(funcs: dict, pairs) -> dict:
    """``funcs`` with OLD replaced by NEW in each function's name, for each
    (OLD, NEW) of ``pairs`` in turn."""
    out = {}
    for name, insns in funcs.items():
        for old, new in pairs:
            name = name.replace(old, new)
        out[name] = insns
    return out


def compare(other: dict, this: dict) -> dict:
    diff = 0
    for name in sorted(set(other) | set(this)):
        a, b = other.get(name, []), this.get(name, [])
        for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes():
            if tag != "equal":
                diff += max(i2 - i1, j2 - j1)
    return dict(functions={n: [len(other.get(n, [])), len(this.get(n, []))]
                           for n in sorted(set(other) | set(this))},
                instructions=[sum(map(len, other.values())), sum(map(len, this.values()))],
                differing_lines=diff)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc")
    ap.add_argument("sources", nargs="*", default=list(SOURCES))
    ap.add_argument("--rename", action="append", default=[], metavar="OLD=NEW",
                    help="read OTHER_CSRC's function names with OLD replaced by NEW")
    args = ap.parse_args(argv)
    pairs = [r.split("=", 1) for r in args.rename]
    differ = False
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as scratch:
        for source in args.sources:
            res = compare(rename(listing(args.other_csrc, source, scratch), pairs),
                          listing(_build.CSRC_DIR, source, scratch))
            differ |= res["differing_lines"] > 0
            print(json.dumps(dict(source=source, **res)), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
