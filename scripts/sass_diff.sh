#!/bin/bash
# Compare the SASS that two trees of the port compile for some kernel
# sources, on a machine with nvcc and cuobjdump:
#
#   scripts/sass_diff.sh build/parent/src build/sass \
#       int8_gemm int4_gemm dual_gemm_gated dual_int4_gemm_gated
#
# PARENT_SRC is the other tree's `src` (`git archive` of the parent commit
# unpacked under build/, which .gitignore lists).  Each source is built in
# both trees (``build.build_all``, each tree into its own build/kernels/),
# disassembled with `cuobjdump -sass`, and stripped of what differs between
# any two builds of one code (the anonymous namespace's hash in kernel
# names, instruction addresses and encodings); OUT_DIR receives
# <name>_N.sass and <name>_P.sass, and one line per source says whether
# they are identical.
set -u
parent=$1
out=$2
shift 2
cuobj=${CUDA_HOME:-/usr/local/cuda}/bin/cuobjdump
mkdir -p "$out"
for tree in src "$parent"; do
  python3 - "$tree" "$@" <<'PY'
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import build
build.build_all(tuple(sys.argv[2:]))
tag = "N" if sys.argv[1] == "src" else "P"
for n in sys.argv[2:]:
    print(n, tag, build.lib_path(n))
PY
done > "$out/libs.txt"
while read -r name tag path; do
  "$cuobj" -sass "$path" \
    | sed -E 's/_GLOBAL__N__[0-9a-f]+_[0-9]+_[A-Za-z0-9_]+_cu_[0-9a-f]+//g; s@/\*[0-9a-f]{4,}\*/@@g; s@/\* 0x[0-9a-f]+ \*/@@g; s/[[:space:]]+/ /g' \
    | grep -v "^ *$" > "$out/${name}_${tag}.sass"
done < "$out/libs.txt"
for k in "$@"; do
  n=$(wc -l < "$out/${k}_N.sass")
  p=$(wc -l < "$out/${k}_P.sass")
  if cmp -s "$out/${k}_N.sass" "$out/${k}_P.sass"; then
    r=identical
  else
    r="DIFFERENT ($(diff "$out/${k}_N.sass" "$out/${k}_P.sass" | grep -c '^[<>]') lines)"
  fi
  echo "sass $k: N $n lines, P $p lines: $r"
done
