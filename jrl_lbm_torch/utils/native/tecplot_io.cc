// Tecplot ASCII writer/reader for the port's dump formats (a copy of the
// JAX package's native/tecplot_io.cc, kept inside the PyTorch package).
//
// The reference writes one formatted line per cell from a Python double
// loop (seconds per 800x400 dump). This formats the whole zone into one
// buffer with a shortest-roundtrip float formatter and writes it once;
// jrl_lbm_torch/utils/native_io.py builds it with g++ at first use and
// binds it with ctypes.
//
// Formatting contract: numbers are written like Python's repr of
// float32-widened-to-double values (the shortest representation that
// round-trips), byte for byte what the Python writers of
// jrl_lbm_torch/utils/io.py emit.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Shortest decimal that round-trips a double, python-repr style
// (always contains '.' or 'e'; Python's float() parses all of these).
// Field values are float32 widened to double because that is what the
// pure-Python writers emit: "{}".format(np.float32) promotes to a
// Python float (double) before repr.
void format_double(double v, std::string* out) {
  // Python writes every NaN as "nan"; to_chars writes "-nan" for one
  // with the sign bit set (a diverged run's rho holds many)
  if (std::isnan(v)) {
    out->append("nan");
    return;
  }
  // std::to_chars emits the shortest representation that round-trips,
  // the same contract as Python's float repr.
  char buf[64];
  auto res = std::to_chars(buf, buf + sizeof(buf) - 4, v);
  *res.ptr = 0;
  if (!strchr(buf, '.') && !strchr(buf, 'e') && !strchr(buf, 'n') &&
      !strchr(buf, 'i')) {
    strcat(buf, ".0");
  }
  out->append(buf);
}

void append_int(long v, std::string* out) {
  char buf[24];
  snprintf(buf, sizeof(buf), "%ld", v);
  out->append(buf);
}

}  // namespace

extern "C" {

// Write the 'X Y C RHO U V NormX NormY' zone (io.py:308-333 layout).
// All field arrays are row-major [H, W] float32. Returns 0 on success.
int tecplot_write_c_rho(const char* filename, const float* C,
                        const float* rho, const float* u, const float* v,
                        int64_t H, int64_t W) {
  std::string out;
  out.reserve(static_cast<size_t>(H * W) * 64 + 256);
  out += "TITLE =\"Magnetic internal force\"\n";
  out += "VARIABLES = \"X\" \"Y\" \"C\" \"RHO\" \"U\" \"V\" \"NormX\" \"NormY\"\n";
  out += "ZONE I=" + std::to_string(W) + ", J=" + std::to_string(H) + "\n";
  out += "F=POINT\n";
  for (int64_t j = 0; j < H; ++j) {
    for (int64_t i = 0; i < W; ++i) {
      const int64_t k = j * W + i;
      append_int(i, &out);
      out += ' ';
      append_int(j, &out);
      out += ' ';
      format_double(static_cast<double>(C[k]), &out);
      out += ' ';
      format_double(static_cast<double>(rho[k]), &out);
      out += ' ';
      format_double(static_cast<double>(u[k]), &out);
      out += ' ';
      format_double(static_cast<double>(v[k]), &out);
      out += ' ';
      format_double(static_cast<double>(i) / 12.5, &out);
      out += ' ';
      format_double(static_cast<double>(j) / 12.5, &out);
      out += '\n';
    }
  }
  FILE* f = fopen(filename, "wb");
  if (!f) return 1;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size() ? 0 : 2;
}

// Write the 'X Y RHO U V' zone (io.py:336-352 layout).
int tecplot_write_single(const char* filename, const float* rho,
                         const float* u, const float* v, int64_t H,
                         int64_t W) {
  std::string out;
  out.reserve(static_cast<size_t>(H * W) * 48 + 256);
  out += "TITLE =\"Magnetic internal force\"\n";
  out += "VARIABLES = \"X\" \"Y\" \"RHO\" \"U\" \"V\" \n";
  out += "ZONE I=" + std::to_string(W) + ", J=" + std::to_string(H) + "\n";
  out += "F=POINT\n";
  for (int64_t j = 0; j < H; ++j) {
    for (int64_t i = 0; i < W; ++i) {
      const int64_t k = j * W + i;
      append_int(i, &out);
      out += ' ';
      append_int(j, &out);
      out += ' ';
      format_double(static_cast<double>(rho[k]), &out);
      out += ' ';
      format_double(static_cast<double>(u[k]), &out);
      out += ' ';
      format_double(static_cast<double>(v[k]), &out);
      out += '\n';
    }
  }
  FILE* f = fopen(filename, "wb");
  if (!f) return 1;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size() ? 0 : 2;
}

// Read back an 'X Y C RHO U V ...' zone: fills 4 preallocated [H*W]
// float32 arrays. Returns 0 on success; H/W are read from the header
// via tecplot_read_dims.
int tecplot_read_dims(const char* filename, int64_t* H, int64_t* W) {
  FILE* f = fopen(filename, "rb");
  if (!f) return 1;
  char line[512];
  for (int k = 0; k < 3; ++k) {
    if (!fgets(line, sizeof(line), f)) {
      fclose(f);
      return 2;
    }
  }
  fclose(f);
  const char* ip = strstr(line, "I=");
  const char* jp = strstr(line, "J=");
  if (!ip || !jp) return 3;
  *W = strtol(ip + 2, nullptr, 10);
  *H = strtol(jp + 2, nullptr, 10);
  return 0;
}

int tecplot_read_c_rho(const char* filename, float* C, float* rho, float* u,
                       float* v, int64_t H, int64_t W) {
  FILE* f = fopen(filename, "rb");
  if (!f) return 1;
  char line[1024];
  for (int k = 0; k < 4; ++k) {
    if (!fgets(line, sizeof(line), f)) {
      fclose(f);
      return 2;
    }
  }
  for (int64_t k = 0; k < H * W; ++k) {
    if (!fgets(line, sizeof(line), f)) {
      fclose(f);
      return 3;
    }
    char* p = line;
    char* end;
    strtod(p, &end);  // X
    p = end;
    strtod(p, &end);  // Y
    p = end;
    C[k] = static_cast<float>(strtod(p, &end));
    p = end;
    rho[k] = static_cast<float>(strtod(p, &end));
    p = end;
    u[k] = static_cast<float>(strtod(p, &end));
    p = end;
    v[k] = static_cast<float>(strtod(p, &end));
  }
  fclose(f);
  return 0;
}

}  // extern "C"
