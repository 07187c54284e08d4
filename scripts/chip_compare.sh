#!/bin/bash
# Run chip_smoke.py's comparison modes on two trees of the port in turns —
# parent, change, change, parent — in one call on one card, so that host
# and device numbers of the two trees are taken side by side:
#
#   scripts/chip_compare.sh build/parent/src chiprun_out/cmp \
#       "--kernels quantize_rows,int_layernorm" --serve-only --lm-only
#
# PARENT_SRC is the parent's `src` (say `git archive` of the parent commit
# unpacked under build/, which .gitignore lists); each run writes
# PREFIX_<n>_<P|N>_<mode>.json (chip_smoke's --out) and .log, and prints
# its exit code and the last line of its summary.  The card's name and
# power limit are printed before and after.
set -u
parent=$1
prefix=$2
shift 2
mkdir -p "$(dirname "$prefix")"
smi() { nvidia-smi --query-gpu=name,power.limit --format=csv,noheader; }
smi
i=0
for mode in "$@"; do
  tag=$(echo "$mode" | tr -dc 'a-z' | head -c 6)
  for tree in P N N P; do
    i=$((i + 1))
    src=()
    [ "$tree" = P ] && src=(--src "$parent")
    out="${prefix}_${i}_${tree}_${tag}"
    echo "=== $i $tree $mode"
    # shellcheck disable=SC2086
    python3 chip_smoke.py $mode "${src[@]}" --out "$out.json" > "$out.log" 2>&1
    echo "rc=$?"
    tail -n 2 "$out.log" | head -n 1 | cut -c1-2000
  done
done
smi
