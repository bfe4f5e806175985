// Native snapshot chunk loader: row-chunk reads from .npy files (the
// port's own copy of the JAX package's loader, built by the port).
//
// The out-of-core POD fit (openmeasure_torch/streaming.py) streams a tall
// (n, m) snapshot matrix through fixed-size host buffers in row chunks.  The
// two on-disk layouts are (a) one C-order (n, m) matrix file, whose row
// chunk is a single contiguous pread, and (b) the reference's per-snapshot
// layout — m separate (n,)/(n, 1) column files (the 3D dataset ships one
// field file per simulation) — whose row chunk is m contiguous per-file
// reads scattered into column-strided positions.  Layout (b) is the hot
// case: the scatter transpose plus dtype conversion is memory-bound and
// parallelizes over files (OpenMP), and ctypes releases the GIL for the
// whole call, so a Python prefetch thread overlaps the next chunk's disk
// reads with the compute on the current one.  The caller gives the output
// buffer, which may be pinned host memory that a copy to the card reads.
//
// Stateless by design (open/pread/close per call): no handle lifecycle to
// leak across Python reloads; header parsing is microseconds against
// multi-MB reads.
//
// Supported .npy subset: format v1/v2/v3, little-endian '<f4'/'<f8', C order
// (fortran_order False), 1-D or 2-D shapes.  Anything else returns an error
// code (-4 dtype, -5 Fortran order, -6 shape), for which the Python side
// reads through numpy; every other error raises there.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>

#include <fcntl.h>
#include <unistd.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// error codes (mirrored in native/__init__.py, _NPY_ERRORS)
constexpr long OK = 0;
constexpr long E_OPEN = -1;
constexpr long E_MAGIC = -2;
constexpr long E_HEADER = -3;
constexpr long E_DTYPE = -4;
constexpr long E_ORDER = -5;
constexpr long E_SHAPE = -6;
constexpr long E_BOUNDS = -7;
constexpr long E_READ = -8;
constexpr long E_ARG = -9;

struct NpyInfo {
  long itemsize = 0;   // 4 or 8
  long ndim = 0;
  long shape[2] = {0, 0};
  long data_offset = 0;
};

long read_exact(int fd, void* buf, size_t count, off_t offset) {
  char* p = static_cast<char*>(buf);
  size_t done = 0;
  while (done < count) {
    ssize_t r = pread(fd, p + done, count - done, offset + done);
    if (r <= 0) return E_READ;
    done += static_cast<size_t>(r);
  }
  return OK;
}

long parse_header(int fd, NpyInfo* info) {
  unsigned char pre[12];
  if (read_exact(fd, pre, 10, 0) != OK) return E_MAGIC;
  if (memcmp(pre, "\x93NUMPY", 6) != 0) return E_MAGIC;
  int major = pre[6];
  long hlen, hoff;
  if (major == 1) {
    hlen = pre[8] | (pre[9] << 8);
    hoff = 10;
  } else {  // v2/v3: 4-byte little-endian header length
    if (read_exact(fd, pre + 10, 2, 10) != OK) return E_HEADER;
    hlen = static_cast<long>(pre[8]) | (static_cast<long>(pre[9]) << 8) |
           (static_cast<long>(pre[10]) << 16) |
           (static_cast<long>(pre[11]) << 24);
    hoff = 12;
  }
  if (hlen <= 0 || hlen > (1 << 20)) return E_HEADER;
  std::string hdr(static_cast<size_t>(hlen), '\0');
  if (read_exact(fd, &hdr[0], static_cast<size_t>(hlen), hoff) != OK)
    return E_HEADER;
  info->data_offset = hoff + hlen;

  // descr
  size_t dp = hdr.find("'descr'");
  if (dp == std::string::npos) return E_HEADER;
  size_t q1 = hdr.find('\'', dp + 7);
  size_t q2 = (q1 == std::string::npos) ? q1 : hdr.find('\'', q1 + 1);
  if (q2 == std::string::npos) return E_HEADER;
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4") info->itemsize = 4;
  else if (descr == "<f8") info->itemsize = 8;
  else return E_DTYPE;

  // fortran_order
  size_t fp = hdr.find("'fortran_order'");
  if (fp == std::string::npos) return E_HEADER;
  size_t colon = hdr.find(':', fp);
  if (colon == std::string::npos) return E_HEADER;
  size_t v = hdr.find_first_not_of(" \t", colon + 1);
  if (v == std::string::npos) return E_HEADER;
  if (hdr.compare(v, 4, "True") == 0) return E_ORDER;
  if (hdr.compare(v, 5, "False") != 0) return E_HEADER;

  // shape
  size_t sp = hdr.find("'shape'");
  if (sp == std::string::npos) return E_HEADER;
  size_t po = hdr.find('(', sp);
  size_t pc = (po == std::string::npos) ? po : hdr.find(')', po);
  if (pc == std::string::npos) return E_HEADER;
  std::string tup = hdr.substr(po + 1, pc - po - 1);
  info->ndim = 0;
  const char* s = tup.c_str();
  char* end = nullptr;
  while (true) {
    while (*s == ' ' || *s == ',') ++s;
    if (*s == '\0') break;
    long dim = strtol(s, &end, 10);
    if (end == s) return E_HEADER;
    if (info->ndim >= 2) return E_SHAPE;
    info->shape[info->ndim++] = dim;
    s = end;
  }
  if (info->ndim == 0) return E_SHAPE;
  return OK;
}

// Convert src (count values of src_item bytes) into dst with dst stride
// (in elements) and dst_item bytes per element.
void convert_strided(const void* src, long src_item, void* dst, long dst_item,
                     long dst_stride, long count) {
  if (src_item == 4 && dst_item == 4) {
    const float* s = static_cast<const float*>(src);
    float* d = static_cast<float*>(dst);
    for (long i = 0; i < count; ++i) d[i * dst_stride] = s[i];
  } else if (src_item == 8 && dst_item == 8) {
    const double* s = static_cast<const double*>(src);
    double* d = static_cast<double*>(dst);
    for (long i = 0; i < count; ++i) d[i * dst_stride] = s[i];
  } else if (src_item == 4 && dst_item == 8) {
    const float* s = static_cast<const float*>(src);
    double* d = static_cast<double*>(dst);
    for (long i = 0; i < count; ++i)
      d[i * dst_stride] = static_cast<double>(s[i]);
  } else {
    const double* s = static_cast<const double*>(src);
    float* d = static_cast<float*>(dst);
    for (long i = 0; i < count; ++i)
      d[i * dst_stride] = static_cast<float>(s[i]);
  }
}

long probe_file(const char* path, NpyInfo* info) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return E_OPEN;
  long rc = parse_header(fd, info);
  close(fd);
  return rc;
}

// Column-file rows: treat (n,) and (n, 1) as an n-vector.
long column_rows(const NpyInfo& info, long* n_out) {
  if (info.ndim == 1) { *n_out = info.shape[0]; return OK; }
  if (info.ndim == 2 && info.shape[1] == 1) { *n_out = info.shape[0]; return OK; }
  return E_SHAPE;
}

}  // namespace

extern "C" {

// Probe a .npy file: fills dtype itemsize (4/8), ndim, shape[2], data offset.
long omtpu_npy_probe(const char* path, long* itemsize, long* ndim,
                     long* shape, long* data_offset) {
  NpyInfo info;
  long rc = probe_file(path, &info);
  if (rc != OK) return rc;
  *itemsize = info.itemsize;
  *ndim = info.ndim;
  shape[0] = info.shape[0];
  shape[1] = info.ndim == 2 ? info.shape[1] : 1;
  *data_offset = info.data_offset;
  return OK;
}

// Read rows [row0, row0+nrows) of a C-order (n, m) matrix file into `out`
// (nrows * m, C-order, out_item = 4 or 8).  One contiguous pread, converted
// in parallel column-of-threads chunks.
long omtpu_read_rows_matrix(const char* path, long row0, long nrows,
                            long out_item, void* out) {
  if (nrows <= 0 || row0 < 0 || (out_item != 4 && out_item != 8))
    return E_ARG;
  NpyInfo info;
  long rc = probe_file(path, &info);
  if (rc != OK) return rc;
  if (info.ndim != 2) return E_SHAPE;
  long n = info.shape[0], m = info.shape[1];
  if (row0 + nrows > n) return E_BOUNDS;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return E_OPEN;
  long count = nrows * m;
  if (info.itemsize == out_item) {
    rc = read_exact(fd, out, static_cast<size_t>(count) * out_item,
                    info.data_offset + row0 * m * info.itemsize);
    close(fd);
    return rc;
  }
  // dtype conversion: read raw then convert in place-adjacent buffer
  char* raw = static_cast<char*>(
      malloc(static_cast<size_t>(count) * info.itemsize));
  if (!raw) { close(fd); return E_READ; }
  rc = read_exact(fd, raw, static_cast<size_t>(count) * info.itemsize,
                  info.data_offset + row0 * m * info.itemsize);
  close(fd);
  if (rc == OK) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long i = 0; i < nrows; ++i) {
      convert_strided(raw + static_cast<size_t>(i) * m * info.itemsize,
                      info.itemsize,
                      static_cast<char*>(out) +
                          static_cast<size_t>(i) * m * out_item,
                      out_item, 1, m);
    }
  }
  free(raw);
  return rc;
}

// Read rows [row0, row0+nrows) across m per-snapshot column files into `out`
// shaped (nrows, m) C-order (out_item = 4 or 8).  Each file contributes one
// column; files are read in parallel.  `paths` is an array of m C strings;
// every file must be (n,) or (n, 1) with the same n.
long omtpu_read_rows_files(const char* const* paths, long m, long row0,
                           long nrows, long out_item, void* out) {
  if (m <= 0 || nrows <= 0 || row0 < 0 || (out_item != 4 && out_item != 8))
    return E_ARG;
  long first_n = -1;
  long status = OK;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (long j = 0; j < m; ++j) {
    long local = OK;
    NpyInfo info;
    local = probe_file(paths[j], &info);
    long n = 0;
    if (local == OK) local = column_rows(info, &n);
    if (local == OK) {
      if (j == 0) first_n = n;
      if (row0 + nrows > n) local = E_BOUNDS;
    }
    int fd = -1;
    char* raw = nullptr;
    if (local == OK) {
      fd = open(paths[j], O_RDONLY);
      if (fd < 0) local = E_OPEN;
    }
    if (local == OK) {
      raw = static_cast<char*>(
          malloc(static_cast<size_t>(nrows) * info.itemsize));
      if (!raw) local = E_READ;
    }
    if (local == OK) {
      local = read_exact(fd, raw,
                         static_cast<size_t>(nrows) * info.itemsize,
                         info.data_offset + row0 * info.itemsize);
    }
    if (local == OK) {
      convert_strided(raw, info.itemsize,
                      static_cast<char*>(out) + static_cast<size_t>(j) *
                          out_item,
                      out_item, m, nrows);
    }
    if (raw) free(raw);
    if (fd >= 0) close(fd);
    if (local != OK) {
#ifdef _OPENMP
#pragma omp critical
#endif
      status = local;
    }
  }
  (void)first_n;
  return status;
}

}  // extern "C"
