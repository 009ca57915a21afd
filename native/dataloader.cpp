// plslam native IO: PNG grayscale decode + CLAHE + batch prefetch helpers.
//
// Native equivalent of the reference's host-side data pump
// (`feature_tracker_node.cpp` image callbacks + cv::imdecode + cv::CLAHE —
// SURVEY.md §2.1). The compute path stays JAX/XLA; this is the runtime IO
// layer the reference also kept native. Exposed as a C ABI consumed from
// Python via ctypes (no pybind11 in the image).
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC, links zlib only).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct Chunk {
  uint32_t length;
  char type[5];
  const uint8_t* data;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit PNG into grayscale float [0,1]. Returns 0 on success.
int decode_png_gray(const uint8_t* buf, size_t len, float* out, int* out_w,
                    int* out_h, int max_w, int max_h) {
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 8 || memcmp(buf, magic, 8) != 0) return -1;
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 12 <= len) {
    uint32_t clen = be32(buf + pos);
    if (clen > len || pos + 12 + size_t(clen) > len) return -7;  // truncated
    const char* ctype = reinterpret_cast<const char*>(buf + pos + 4);
    const uint8_t* cdata = buf + pos + 8;
    if (memcmp(ctype, "IHDR", 4) == 0) {
      if (clen < 13) return -7;
      w = be32(cdata);
      h = be32(cdata + 4);
      bit_depth = cdata[8];
      color_type = cdata[9];
      interlace = cdata[12];
    } else if (memcmp(ctype, "IDAT", 4) == 0) {
      idat.insert(idat.end(), cdata, cdata + clen);
    } else if (memcmp(ctype, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + clen;
  }
  if (w == 0 || h == 0 || bit_depth != 8 || interlace != 0) return -2;
  if ((int)w > max_w || (int)h > max_h) return -3;
  int nch;
  switch (color_type) {
    case 0: nch = 1; break;
    case 2: nch = 3; break;
    case 4: nch = 2; break;
    case 6: nch = 4; break;
    default: return -4;
  }
  const size_t stride = size_t(w) * nch;
  std::vector<uint8_t> raw(h * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return -5;
  if (raw_len != (uLongf)raw.size()) return -5;  // short stream

  std::vector<uint8_t> prev(stride, 0), line(stride);
  size_t rp = 0;
  for (uint32_t y = 0; y < h; y++) {
    int filt = raw[rp++];
    memcpy(line.data(), raw.data() + rp, stride);
    rp += stride;
    uint8_t* cur = line.data();
    switch (filt) {
      case 0:
        break;
      case 1:
        for (size_t x = nch; x < stride; x++) cur[x] += cur[x - nch];
        break;
      case 2:
        for (size_t x = 0; x < stride; x++) cur[x] += prev[x];
        break;
      case 3:
        for (size_t x = 0; x < stride; x++) {
          int a = x >= (size_t)nch ? cur[x - nch] : 0;
          cur[x] += uint8_t((a + prev[x]) >> 1);
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; x++) {
          int a = x >= (size_t)nch ? cur[x - nch] : 0;
          int c = x >= (size_t)nch ? prev[x - nch] : 0;
          cur[x] += uint8_t(paeth(a, prev[x], c));
        }
        break;
      default:
        return -6;
    }
    float* orow = out + size_t(y) * w;
    if (nch == 1) {
      for (uint32_t x = 0; x < w; x++) orow[x] = cur[x] * (1.0f / 255.0f);
    } else {
      for (uint32_t x = 0; x < w; x++) {
        int s = 0;
        int base = x * nch;
        int nc = nch >= 3 ? 3 : 1;  // average rgb; ignore alpha
        for (int k = 0; k < nc; k++) s += cur[base + k];
        orow[x] = (s / float(nc)) * (1.0f / 255.0f);
      }
    }
    prev = line;
  }
  *out_w = (int)w;
  *out_h = (int)h;
  return 0;
}

}  // namespace

extern "C" {

// Decode a PNG file from disk. out must hold max_w*max_h floats.
int plslam_load_png_gray(const char* path, float* out, int* out_w, int* out_h,
                         int max_w, int max_h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len);
  size_t rd = fread(buf.data(), 1, len, f);
  fclose(f);
  if ((long)rd != len) return -11;
  return decode_png_gray(buf.data(), len, out, out_w, out_h, max_w, max_h);
}

// CLAHE: contrast-limited adaptive histogram equalization, 8x8 tiles,
// clip=3.0 — matches the reference's cv::createCLAHE(3.0, {8,8}).
void plslam_clahe(const float* in, float* out, int h, int w, float clip,
                  int tiles) {
  const int th = h / tiles, tw = w / tiles;
  std::vector<float> luts(size_t(tiles) * tiles * 256);
  for (int ti = 0; ti < tiles; ti++) {
    for (int tj = 0; tj < tiles; tj++) {
      int hist[256] = {0};
      for (int y = ti * th; y < (ti + 1) * th; y++)
        for (int x = tj * tw; x < (tj + 1) * tw; x++) {
          int v = (int)(in[size_t(y) * w + x] * 255.0f + 0.5f);
          hist[v < 0 ? 0 : (v > 255 ? 255 : v)]++;
        }
      const float limit = clip * th * tw / 256.0f;
      float excess = 0.f;
      float capped[256];
      for (int i = 0; i < 256; i++) {
        float hv = (float)hist[i];
        if (hv > limit) {
          excess += hv - limit;
          hv = limit;
        }
        capped[i] = hv;
      }
      const float redist = excess / 256.0f;
      float cdf = 0.f, total = 0.f;
      for (int i = 0; i < 256; i++) total += capped[i] + redist;
      float* lut = &luts[(size_t(ti) * tiles + tj) * 256];
      for (int i = 0; i < 256; i++) {
        cdf += capped[i] + redist;
        lut[i] = cdf / total;
      }
    }
  }
  // bilinear blend between tile LUTs
  for (int y = 0; y < h; y++) {
    float fy = ((float)y - th * 0.5f) / th;
    fy = fy < 0 ? 0 : (fy > tiles - 1.001f ? tiles - 1.001f : fy);
    int y0 = (int)fy;
    float wy = fy - y0;
    int y1 = y0 + 1 < tiles ? y0 + 1 : tiles - 1;
    for (int x = 0; x < w; x++) {
      float fx = ((float)x - tw * 0.5f) / tw;
      fx = fx < 0 ? 0 : (fx > tiles - 1.001f ? tiles - 1.001f : fx);
      int x0 = (int)fx;
      float wx = fx - x0;
      int x1 = x0 + 1 < tiles ? x0 + 1 : tiles - 1;
      int v = (int)(in[size_t(y) * w + x] * 255.0f + 0.5f);
      v = v < 0 ? 0 : (v > 255 ? 255 : v);
      float l00 = luts[(size_t(y0) * tiles + x0) * 256 + v];
      float l01 = luts[(size_t(y0) * tiles + x1) * 256 + v];
      float l10 = luts[(size_t(y1) * tiles + x0) * 256 + v];
      float l11 = luts[(size_t(y1) * tiles + x1) * 256 + v];
      out[size_t(y) * w + x] = l00 * (1 - wx) * (1 - wy) + l01 * wx * (1 - wy) +
                               l10 * (1 - wx) * wy + l11 * wx * wy;
    }
  }
}

}  // extern "C"
