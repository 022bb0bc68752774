#!/usr/bin/env bash
# Write the small variants of K1 (src/repro_torch/kernels/csrc/hash_probe.cu
# as it stands, one idea changed) into DEST (default build/k1_variants), for
# tools/k1_ab.py to time beside it:
#   rows1.cu             one query row a thread on a large call (kRows = 1)
#   rows4.cu             four rows a thread on a large call (kRows = 4)
#   rows2_always.cu      probe_rows, two rows a thread, on every call
#   lockstep_small.cu    probe_rows with one row a thread on a small call,
#                        not probe_sector
#   sector_always.cu     probe_sector on every call, large ones too
#   threads256.cu        blocks of 256 threads (kNT = 256)
#   table_cg.cu          the table read past L1 (__ldcg: ld.global.cg)
#   table_evict_last.cu  the table read under an L2 evict-last policy
#   no_stream.cu         query rows read and results written with the
#                        default cache policy, not as streaming accesses
# Run from the repository root; fails if an edit no longer changes the
# source.
set -euo pipefail
src=src/repro_torch/kernels/csrc/hash_probe.cu
here=$(dirname "$0")
dest=${1:-build/k1_variants}
mkdir -p "$dest"

edit() {  # NAME SED-EXPRESSION...: each expression must change the text
  local name=$1 out=$dest/$1.cu
  shift
  cp "$src" "$out"
  for expr in "$@"; do
    sed -e "$expr" "$out" > "$out.next"
    if cmp -s "$out" "$out.next"; then
      echo "edits.sh: $name: '$expr' no longer changes $src" >&2
      exit 1
    fi
    mv "$out.next" "$out"
  done
}

helpers="/^namespace {\$/r $here/helpers.inc"
edit rows1 's/constexpr int kRows = 2;/constexpr int kRows = 1;/'
edit rows4 's/constexpr int kRows = 2;/constexpr int kRows = 4;/'
large='if (static_cast<long long>(nq) >= static_cast<long long>(kLargeCall) \* sms \* per_sm) {'
edit rows2_always "s/$large/if (true) {/"
edit lockstep_small 's/probe_sector<K><<<blocks_for(nq, 1)/probe_rows<K, 1><<<blocks_for(nq, 1)/'
edit sector_always "s/$large/if (false) {/"
edit threads256 's/constexpr int kNT = 128;/constexpr int kNT = 256;/'
edit table_cg 's/__ldg(/__ldcg(/g'
edit table_evict_last "$helpers" 's/__ldg(/ld_evict_last(/g'
edit no_stream "$helpers" 's/__ldcs(/ld_default(/g' 's/__stcs(/st_default(/g'
ls "$dest"
