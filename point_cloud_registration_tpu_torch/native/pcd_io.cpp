// Fast PCD point-cloud reader (native IO layer).
//
// The reference library delegates IO to the optional q3dviewer GUI package
// (benchmark/test_data.py:12) and its native-code needs to kd-tree backends;
// this framework's host-side native layer instead accelerates the data path:
// million-point PCD files are parsed here at memcpy speed and handed to the
// Python layer as flat float32 xyz buffers (see utils/io.py, which falls
// back to a pure-NumPy parser when this library is unavailable).
//
// Supports PCD v0.7 "ascii" and "binary" encodings with arbitrary scalar
// fields; only x/y/z are extracted. Exposed via a minimal C ABI for ctypes.
//
// Build: point_cloud_registration_tpu_torch/native/__init__.py load()  (g++ -O3 -shared)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Header {
  std::vector<std::string> fields;
  std::vector<int> sizes;
  std::vector<char> types;
  std::vector<int> counts;
  long points = -1;
  std::string data_mode;
  long header_end = 0;  // byte offset where data starts
};

bool parse_header(FILE* f, Header* h) {
  char line[4096];
  while (fgets(line, sizeof(line), f)) {
    std::string s(line);
    if (!s.empty() && s[0] == '#') continue;
    char key[64];
    if (sscanf(line, "%63s", key) != 1) continue;
    std::string k(key);
    const char* rest = line + k.size();
    if (k == "FIELDS") {
      char name[64];
      int off = 0, used = 0;
      while (sscanf(rest + off, "%63s%n", name, &used) == 1) {
        h->fields.emplace_back(name);
        off += used;
      }
    } else if (k == "SIZE") {
      int v, off = 0, used = 0;
      while (sscanf(rest + off, "%d%n", &v, &used) == 1) {
        h->sizes.push_back(v);
        off += used;
      }
    } else if (k == "TYPE") {
      char c, off = 0;
      int used = 0, o = 0;
      while (sscanf(rest + o, " %c%n", &c, &used) == 1) {
        h->types.push_back(c);
        o += used;
      }
      (void)off;
    } else if (k == "COUNT") {
      int v, off = 0, used = 0;
      while (sscanf(rest + off, "%d%n", &v, &used) == 1) {
        h->counts.push_back(v);
        off += used;
      }
    } else if (k == "POINTS") {
      sscanf(rest, "%ld", &h->points);
    } else if (k == "DATA") {
      char mode[32];
      if (sscanf(rest, "%31s", mode) == 1) h->data_mode = mode;
      h->header_end = ftell(f);
      break;
    }
  }
  if (h->counts.empty()) h->counts.assign(h->fields.size(), 1);
  return h->points >= 0 && !h->data_mode.empty() &&
         h->fields.size() == h->sizes.size() &&
         h->fields.size() == h->types.size();
}

// Convert one field element at p (type t, size s) to float.
inline float to_float(const uint8_t* p, char t, int s) {
  switch (t) {
    case 'F':
      if (s == 4) { float v; memcpy(&v, p, 4); return v; }
      if (s == 8) { double v; memcpy(&v, p, 8); return (float)v; }
      break;
    case 'I':
      if (s == 1) return (float)*(const int8_t*)p;
      if (s == 2) { int16_t v; memcpy(&v, p, 2); return (float)v; }
      if (s == 4) { int32_t v; memcpy(&v, p, 4); return (float)v; }
      break;
    case 'U':
      if (s == 1) return (float)*p;
      if (s == 2) { uint16_t v; memcpy(&v, p, 2); return (float)v; }
      if (s == 4) { uint32_t v; memcpy(&v, p, 4); return (float)v; }
      break;
  }
  return 0.0f;
}

}  // namespace

extern "C" {

// Number of points in the file, or -1 on parse failure.
long pcd_num_points(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  bool ok = parse_header(f, &h);
  fclose(f);
  return ok ? h.points : -1;
}

// Read xyz into out (n*3 floats). Returns 0 on success, negative error code.
int pcd_read_xyz(const char* path, float* out, long n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  if (!parse_header(f, &h) || h.points < n) {
    fclose(f);
    return -2;
  }
  // locate x, y, z fields
  int xi = -1, yi = -1, zi = -1;
  for (size_t i = 0; i < h.fields.size(); ++i) {
    if (h.fields[i] == "x") xi = (int)i;
    if (h.fields[i] == "y") yi = (int)i;
    if (h.fields[i] == "z") zi = (int)i;
  }
  if (xi < 0 || yi < 0 || zi < 0) {
    fclose(f);
    return -3;
  }

  if (h.data_mode == "binary") {
    long stride = 0;
    std::vector<long> offsets(h.fields.size());
    for (size_t i = 0; i < h.fields.size(); ++i) {
      offsets[i] = stride;
      stride += (long)h.sizes[i] * h.counts[i];
    }
    std::vector<uint8_t> buf((size_t)stride * 4096);
    long done = 0;
    fseek(f, h.header_end, SEEK_SET);
    while (done < n) {
      long want = n - done < 4096 ? n - done : 4096;
      size_t got = fread(buf.data(), (size_t)stride, (size_t)want, f);
      if (got == 0) break;
      for (size_t r = 0; r < got; ++r) {
        const uint8_t* rec = buf.data() + r * stride;
        float* o = out + (done + (long)r) * 3;
        o[0] = to_float(rec + offsets[xi], h.types[xi], h.sizes[xi]);
        o[1] = to_float(rec + offsets[yi], h.types[yi], h.sizes[yi]);
        o[2] = to_float(rec + offsets[zi], h.types[zi], h.sizes[zi]);
      }
      done += (long)got;
    }
    fclose(f);
    return done == n ? 0 : -4;
  }

  if (h.data_mode == "ascii") {
    int nf = 0;
    for (size_t i = 0; i < h.fields.size(); ++i) nf += h.counts[i];
    std::vector<double> row(nf);
    int xcol = 0, ycol = 0, zcol = 0, col = 0;
    for (size_t i = 0; i < h.fields.size(); ++i) {
      if ((int)i == xi) xcol = col;
      if ((int)i == yi) ycol = col;
      if ((int)i == zi) zcol = col;
      col += h.counts[i];
    }
    for (long r = 0; r < n; ++r) {
      for (int c = 0; c < nf; ++c) {
        if (fscanf(f, "%lf", &row[c]) != 1) {
          fclose(f);
          return -4;
        }
      }
      out[r * 3 + 0] = (float)row[xcol];
      out[r * 3 + 1] = (float)row[ycol];
      out[r * 3 + 2] = (float)row[zcol];
    }
    fclose(f);
    return 0;
  }

  fclose(f);
  return -5;  // binary_compressed unsupported
}

// Write n xyz float32 points as binary PCD. Returns 0 on success.
int pcd_write_xyz(const char* path, const float* pts, long n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f,
          "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
          "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
          "WIDTH %ld\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS %ld\n"
          "DATA binary\n",
          n, n);
  size_t wrote = fwrite(pts, sizeof(float) * 3, (size_t)n, f);
  fclose(f);
  return wrote == (size_t)n ? 0 : -2;
}

}  // extern "C"
