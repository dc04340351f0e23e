#!/bin/bash
# Sanitizer runs of the port's native sampler: sampler_test.cpp against
# sampler.cpp under ASan + UBSan, then TSan. The binaries go to $TMPDIR
# (/tmp without it).
set -e
cd "$(dirname "$0")"
out="${TMPDIR:-/tmp}"

echo "== ASan + UBSan =="
g++ -O1 -g -std=c++17 -fsanitize=address,undefined -fno-omit-frame-pointer \
    sampler.cpp sampler_test.cpp -o "$out/sptpu_torch_asan_test"
"$out/sptpu_torch_asan_test"

echo "== TSan =="
g++ -O1 -g -std=c++17 -fsanitize=thread -fno-omit-frame-pointer \
    sampler.cpp sampler_test.cpp -o "$out/sptpu_torch_tsan_test"
"$out/sptpu_torch_tsan_test"

echo "sanitizers clean"
