"""Compare the kernels of two builds of ``csrc/``: ptxas resources and SASS.

    python -m mcmc_spec_tpu_torch.runtime.compare_builds <other checkout>

builds the kernels of this checkout and of another one (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists), each with its own ``runtime/cuda_build.py``.  For every
kernel of the other build it prints whether this build has it with the same
ptxas line (registers, barriers, stack, shared memory) and the same SASS
(``cuobjdump -sass``: each instruction's text and both of its encoding
words), then the groups of this build's kernels that compile to one SASS.  A
kernel whose parameters changed (another mangled name) is held against the one
kernel of this build with its qualified name.  It exits 1 when a kernel of the
other build is missing here or differs.  It needs the CUDA toolkit (nvcc,
cuobjdump), not a card.

Most kernels of the port include the shared device bodies
(``spectrum_block.cuh``, ``posterior_body.cuh``, ``block_common.cuh``), and the
experiment kernels are instantiations of them behind compile-time flags that
default to the production code.  An edit to one of those headers (a new flag,
a new body beside them) must show which production kernels it changed; a time
on the card cannot, since K1's run-to-run spread is about 5 %.
"""
from __future__ import annotations

import hashlib
import re
import subprocess
import sys
from pathlib import Path

from mcmc_spec_tpu_torch.runtime import cuda_build

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")


def ptxas_lines(log: str) -> dict:
    """{kernel: its ptxas 'Used ...' line} from an nvcc ``-Xptxas -v`` log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1)
        elif cur and "Used" in line:
            out[cur] = line.split(":", 1)[1].strip()
    return out


def sass(dump: str) -> dict:
    """{kernel: [line, ...]} from ``cuobjdump -sass`` output: each instruction with
    its two encoding words, without its address and with runs of blanks made one
    (cuobjdump pads the columns to a width that differs from kernel to kernel)."""
    out, cur = {}, None
    for line in dump.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None and "/*" in line:
            ins = " ".join(_ADDRESS.sub("", line).split())
            if ins:
                cur.append(ins)
    return out


def build(checkout: Path) -> list:
    """The kernel libraries of ``checkout``, each built by that checkout's own
    ``cuda_build``: the kernels' and, where it has one, the attribution tools'."""
    code = ("from mcmc_spec_tpu_torch.runtime import cuda_build as c; print(c.build()); "
            "[print(c.build(n)) for n in getattr(c, 'LIBRARIES', ()) if n != 'kernels']")
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True,
                          text=True, check=True)
    return [Path(line) for line in proc.stdout.split() if line.endswith(".so")]


def describe(libs) -> tuple:
    """(ptxas lines, SASS) of the kernels of built libraries."""
    cuobjdump = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    lines, code = {}, {}
    for lib in libs:
        dump = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        lines.update(ptxas_lines(lib.with_suffix(".log").read_text()))
        code.update(sass(dump))
    return lines, code


def base_name(mangled: str) -> str:
    """The qualified name (``mcmc_spec::kernel``) of an Itanium-mangled nested
    name, without its template and parameter encoding; other names as they are."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, parts = 3, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        parts.append(mangled[j:j + n])
        i = j + n
    return "::".join(parts) or mangled


def counterpart(kernel: str, names) -> str:
    """``kernel`` if ``names`` has it, else the one name of ``names`` with its
    base name (a kernel whose parameters changed), else ``kernel``."""
    if kernel in names:
        return kernel
    same = [n for n in names if base_name(n) == base_name(kernel)]
    return same[0] if len(same) == 1 else kernel


def compare(other: tuple, this: tuple) -> list:
    """[(kernel, same ptxas line, same SASS)] for every kernel of ``other``, each held
    against its counterpart in ``this``."""
    (p_other, s_other), (p_this, s_this) = other, this
    rows = []
    for k in sorted(p_other):
        t = counterpart(k, p_this)
        rows.append((k, p_other[k] == p_this.get(t), s_other.get(k) == s_this.get(t)))
    return rows


def same_sass_groups(s: dict) -> list:
    """Groups (two or more) of kernels whose SASS is identical."""
    by_hash = {}
    for name, body in s.items():
        by_hash.setdefault(hashlib.sha256("\n".join(body).encode()).hexdigest(), []).append(name)
    return sorted(sorted(g) for g in by_hash.values() if len(g) > 1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    this = describe(build(Path(__file__).resolve().parents[2]))
    other = describe(build(Path(argv[0]).resolve()))
    rows = compare(other, this)
    for name, same_ptxas, same_sass in rows:
        t = counterpart(name, this[0])
        print(f"{'same' if same_ptxas else 'DIFF'} ptxas, {'same' if same_sass else 'DIFF'} SASS "
              f"({len(this[1].get(t, []))} SASS lines): {name}\n"
              f"    other: {other[0][name]}\n    this:  {this[0].get(t)}"
              + (f" (as {t})" if t != name and t in this[0] else ""))
    for group in same_sass_groups(this[1]):
        print("one SASS:", ", ".join(group))
    return 0 if all(p and s for _, p, s in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
