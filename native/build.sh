#!/bin/sh
# Build the plslam native IO library (C++, zlib only). The library is written
# under a temporary name and renamed into place, so processes that build at
# the same time never load a half-written file.
set -e
cd "$(dirname "$0")"
tmp="libplslam_io.so.tmp.$$"
g++ -O3 -shared -fPIC -std=c++17 -o "$tmp" dataloader.cpp -lz
mv -f "$tmp" libplslam_io.so
echo "built $(pwd)/libplslam_io.so"
