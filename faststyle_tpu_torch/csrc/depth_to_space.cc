// Host-side pack and unpack of uint8 RGB frames for packed-u8 serving (the
// port's own copy of faststyle_tpu/native/depth_to_space.cc). Host code, not
// a device kernel: built with the host C++ compiler into a plain C library
// and called through ctypes, which releases the GIL, so a large frame splits
// into row slabs across a thread pool (inference.pack_u8_host /
// unpack_u8_host).
//
// Packed layout, p = 4, c = 3 (48 bytes per cell):
//   src[by, bx, (dy*p+dx)*c+ch] == dst[by*p+dy, bx*p+dx, ch]
// The logical extent (h, w) crops the packed grid's zero tails.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// src: [hb, wb, p*p*c] row-major uint8; dst: [h, w, c] row-major uint8.
// Requires h <= hb*p, w <= wb*p. Processes packed block-rows [by0, by1):
// each block-row's writes stay inside its own `p` destination rows, so
// disjoint ranges can run on concurrent threads.
void fs_unpack_u8_rows(const uint8_t* src, uint8_t* dst, long hb, long wb,
                       long p, long c, long h, long w, long by0, long by1) {
  const long block = p * p * c;  // bytes per packed cell
  const long row_c = p * c;      // contiguous bytes per (dy) slice of a cell
  const long wfull = wb * p;     // full packed width in pixels
  for (long by = by0; by < by1; ++by) {
    const uint8_t* src_row = src + by * wb * block;
    for (long dy = 0; dy < p; ++dy) {
      const long y = by * p + dy;
      if (y >= h) return;  // rows below h are tail padding
      uint8_t* out = dst + y * w * c;
      const uint8_t* in = src_row + dy * row_c;
      if (w == wfull && row_c == 12 && block == 48) {
        // hot case (p=4, c=3): copy 16 bytes per 12-byte cell slice; the
        // 4-byte overhang lands where the next cell writes anyway (the
        // final cell uses an exact 12-byte copy to stay in bounds). Fixed
        // sizes let the compiler inline the copies.
        for (long bx = 0; bx + 1 < wb; ++bx)
          std::memcpy(out + bx * 12, in + bx * 48, 16);
        std::memcpy(out + (wb - 1) * 12, in + (wb - 1) * 48, 12);
      } else if (w == wfull) {
        // aligned width: every cell contributes all p*c bytes
        for (long bx = 0; bx < wb; ++bx)
          std::memcpy(out + bx * row_c, in + bx * block, row_c);
      } else {
        long written = 0;
        for (long bx = 0; bx < wb && written < w * c; ++bx) {
          const long n = (written + row_c <= w * c) ? row_c : w * c - written;
          std::memcpy(out + written, in + bx * block, n);
          written += n;
        }
      }
    }
  }
}

// Reflect-pad an RGB uint8 frame by `pad` pixels (TF REFLECT: mirror
// excluding the edge) and space-to-depth pack it at p=4 in one pass.
// dst: [ceil((h+2*pad)/4), ceil((w+2*pad)/4), 48] row-major uint8; cells
// beyond the padded extent are zeroed (ragged sizes). Requires h, w > pad.
//
// Row-range form: processes packed block-rows [by0, by1). Every write,
// including the ragged-tail memset and the dy==3 overhang guard, stays
// inside the slab's own block-rows, so disjoint slabs run in parallel.
void fs_pack_u8_rows(const uint8_t* src, uint8_t* dst, long h, long w,
                     long pad, long by0, long by1) {
  const long c = 3, p = 4;
  const long hp = h + 2 * pad, wp = w + 2 * pad;
  const long hb = (hp + p - 1) / p, wb = (wp + p - 1) / p;
  const long row_c = p * c;       // 12 bytes per (dy) slice of a cell
  const long block = p * p * c;   // 48 bytes per cell
  if (hb * p != hp || wb * p != wp)
    std::memset(dst + by0 * wb * block, 0, (by1 - by0) * wb * block);
  // one padded row in scratch; rebuilt per (by, dy)
  uint8_t* row = new uint8_t[wb * p * c]();
  for (long by = by0; by < by1; ++by) {
    uint8_t* dst_row = dst + by * wb * block;
    for (long dy = 0; dy < p; ++dy) {
      const long y = by * p + dy;
      if (y >= hp) break;
      // source row via reflection
      long sy = y - pad;
      if (sy < 0) sy = -sy;
      else if (sy >= h) sy = 2 * (h - 1) - sy;
      const uint8_t* s = src + sy * w * c;
      for (long x = 0; x < pad; ++x)
        std::memcpy(row + x * c, s + (pad - x) * c, c);
      std::memcpy(row + pad * c, s, w * c);
      for (long x = 0; x < pad; ++x)
        std::memcpy(row + (pad + w + x) * c, s + (w - 2 - x) * c, c);
      if (wb * p != wp)
        std::memset(row + wp * c, 0, (wb * p - wp) * c);
      // scatter the row's 12-byte slices into the (dy) lane of each cell
      uint8_t* out = dst_row + dy * row_c;
      if (dy + 1 < p && y + 1 < hp) {  // the next slice is rewritten later
        // (a tail row would keep the 4-byte overhang as garbage)
        for (long bx = 0; bx + 1 < wb; ++bx)
          std::memcpy(out + bx * block, row + bx * row_c, 16);
        std::memcpy(out + (wb - 1) * block, row + (wb - 1) * row_c, row_c);
      } else {
        // dy==3's 16-byte overhang would clobber the NEXT cell's dy=0
        // slice (already written): exact copies only
        for (long bx = 0; bx < wb; ++bx)
          std::memcpy(out + bx * block, row + bx * row_c, row_c);
      }
    }
  }
  delete[] row;
}

}  // extern "C"
