// Banded SpMM with the fused spill window, star-table selection and
// accumulator add, for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces the TPU kernel buckgnn_tpu/ops/pallas_banded.py::_kernel
// (launched by pallas_banded_matmul). The kernel is banded.cuh::
// banded_kernel, which also serves as the merged backward's band pass
// (sage_layer_bwd.cu); this file is its C entry point.
//
// The TPU kernel applies the spill window and the table as one-hot
// selection products ([T, 256] @ window, [T, tg] @ table). Each row of the
// spill one-hot selects one contiguous run [lo, hi) of window rows (the
// spill list is receiver-sorted) and each row of the table one-hot at most
// one table row, so here a warp adds the selected rows directly: the same
// f32 sum without the zero products. The spill run is summed on its own
// and then added, as the TPU adds its spill product to the band product.
//
// What bounds it on an H100: at the virtual-edge shape (N = 103,424,
// T = 256, W = 64, H = 512, Es = 34,176) the band product is 34 GFLOP of
// bf16 products (0.034 ms at 989 TFLOP/s) against ~0.39 GB of compulsory
// traffic (x, acc and out 106 MB each, the band 33 MB, the messages
// 35 MB): 0.12 ms at 3.35 TB/s, so it is bound by bytes.

#include "banded.cuh"

extern "C" int banded_matmul(
    const void* x, const void* band, const void* msgs, const void* off,
    const void* lo, const void* hi, const void* gcode, const void* table,
    const void* acc, void* out, int n, int h, int tile, int width,
    int n_spill, int tg, int has_spill, int has_table, int has_acc,
    int out_f32, void* stream) {
  sage::BandParams p;
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
    case 128: return (int)sage::launch_banded<128>(p, st);
    case 256: return (int)sage::launch_banded<256>(p, st);
    case 512: return (int)sage::launch_banded<512>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
