// Banded SpMM with the fused spill window, star-table selection and
// accumulator add, for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces the TPU kernel buckgnn_tpu/ops/pallas_banded.py::_kernel
// (launched by pallas_banded_matmul). This file is the C entry point of the
// band kernel of banded.cuh, which also runs the merged backward's band
// pass (sage_layer_bwd.cu); that header says what the kernel computes, what
// bounds it on an H100 (bytes: ~0.39 GB of compulsory traffic at the
// virtual-edge shape, 0.115 ms at 3.35 TB/s, against 0.034 ms of bf16
// products) and how its design keeps HBM busy (#1's phase 1 on the product
// engine, persistent clusters that walk 128-row tile pairs, the next
// pair's slab slices in flight during each epilogue).

#include "banded.cuh"

extern "C" int banded_matmul(
    const void* x, const void* band, const void* msgs, const void* off,
    const void* lo, const void* hi, const void* gcode, const void* table,
    const void* acc, void* out, int n, int h, int tile, int width,
    int n_spill, int tg, int has_spill, int has_table, int has_acc,
    int out_f32, void* stream) {
  banded::Params p = {};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.band = static_cast<const int8_t*>(band);
  p.msgs = static_cast<const __nv_bfloat16*>(msgs);
  p.off = static_cast<const int*>(off);
  p.lo = static_cast<const int*>(lo);
  p.hi = static_cast<const int*>(hi);
  p.gcode = static_cast<const int*>(gcode);
  p.table = static_cast<const __nv_bfloat16*>(table);
  p.acc = static_cast<const __nv_bfloat16*>(acc);
  p.out = out;
  p.n = n;
  p.tile = tile;
  p.width = width;
  p.n_spill = n_spill;
  p.tg = tg;
  p.has_spill = has_spill;
  p.has_table = has_table;
  p.has_acc = has_acc;
  p.out_f32 = out_f32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 128: return (int)banded::launch<128>(p, st);
    case 256: return (int)banded::launch<256>(p, st);
    case 512: return (int)banded::launch<512>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
