// gitax native data-loader: batched base64 -> JPEG decode -> resize ->
// center-crop on host threads.
//
// The reference's TSV pipeline decodes with PIL one image at a time
// (inference.py:171-212); at gitax's device throughput (300+ img/s/chip)
// Python-side decode becomes the bottleneck.  This extension runs the
// whole host path in C++ with a thread pool and hands back a single
// contiguous uint8 [N, crop, crop, 3] buffer ready for one
// host->device transfer (normalization then runs fused on device —
// uint8 transfer is 4x smaller than f32).
//
// Resize uses PIL's convolution resampling (bicubic kernel a=-0.5 with
// support scaling / antialias on downscale), so outputs track the PIL
// reference path closely (small rounding differences only: PIL uses
// fixed-point coefficients).
//
// Build: gitax.native builds this lazily with g++ (see __init__.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <jpeglib.h>

#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- base64
int b64val(unsigned char c) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '+') return 62;
  if (c == '/') return 63;
  return -1;
}

bool base64_decode(const unsigned char* in, size_t n, std::vector<unsigned char>* out) {
  out->clear();
  out->reserve(n / 4 * 3);
  int buf = 0, bits = 0;
  for (size_t i = 0; i < n; i++) {
    unsigned char c = in[i];
    if (c == '=' || c == '\n' || c == '\r') continue;
    int v = b64val(c);
    if (v < 0) return false;
    buf = (buf << 6) | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out->push_back((unsigned char)((buf >> bits) & 0xFF));
    }
  }
  return true;
}

// ------------------------------------------------------------------ jpeg
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg_rgb(const unsigned char* data, size_t len,
                     std::vector<unsigned char>* rgb, int* w, int* h,
                     int min_short_side = 0, int* orig_w = nullptr,
                     int* orig_h = nullptr) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  if (orig_w) *orig_w = (int)cinfo.image_width;
  if (orig_h) *orig_h = (int)cinfo.image_height;
  if (min_short_side > 0) {
    // decode directly at reduced scale (libjpeg supports denom 1/2/4/8):
    // pick the largest reduction whose short side still covers the
    // resize target — cuts IDCT+resample cost ~scale^2 for big photos
    int short_side =
        (int)(cinfo.image_width < cinfo.image_height ? cinfo.image_width
                                                     : cinfo.image_height);
    int denom = 1;
    while (denom < 8 && short_side / (denom * 2) >= min_short_side) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize((size_t)(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb->data() + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------- PIL-style resample
// bicubic kernel, a = -0.5 (PIL ImagingResampleBicubic)
double cubic(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// horizontal resample of interleaved RGB rows: [h, w_in] -> [h, w_out]
void resample_axis(const float* src, int h, int w_in, float* dst, int w_out) {
  double scale = (double)w_in / w_out;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<int> bounds(2 * w_out);
  std::vector<double> kk((size_t)w_out * ksize);
  for (int xx = 0; xx < w_out; xx++) {
    double center = (xx + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > w_in) xmax = w_in;
    xmax -= xmin;
    double* k = &kk[(size_t)xx * ksize];
    double wsum = 0.0;
    for (int x = 0; x < xmax; x++) {
      double wgt = cubic((x + xmin - center + 0.5) / filterscale);
      k[x] = wgt;
      wsum += wgt;
    }
    if (wsum != 0.0)
      for (int x = 0; x < xmax; x++) k[x] /= wsum;
    bounds[2 * xx] = xmin;
    bounds[2 * xx + 1] = xmax;
  }
  for (int y = 0; y < h; y++) {
    const float* srow = src + (size_t)y * w_in * 3;
    float* drow = dst + (size_t)y * w_out * 3;
    for (int xx = 0; xx < w_out; xx++) {
      int xmin = bounds[2 * xx], xmax = bounds[2 * xx + 1];
      const double* k = &kk[(size_t)xx * ksize];
      double s0 = 0, s1 = 0, s2 = 0;
      for (int x = 0; x < xmax; x++) {
        const float* p = srow + (size_t)(x + xmin) * 3;
        s0 += p[0] * k[x];
        s1 += p[1] * k[x];
        s2 += p[2] * k[x];
      }
      drow[3 * xx] = (float)s0;
      drow[3 * xx + 1] = (float)s1;
      drow[3 * xx + 2] = (float)s2;
    }
  }
}

void transpose_rgb(const float* src, int h, int w, float* dst) {
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      const float* p = src + ((size_t)y * w + x) * 3;
      float* q = dst + ((size_t)x * h + y) * 3;
      q[0] = p[0];
      q[1] = p[1];
      q[2] = p[2];
    }
}

// full chain for one image: jpeg/base64 -> resize shorter side to
// `size` -> center crop [size, size] -> uint8 RGB
bool process_one(const unsigned char* data, size_t len, bool is_b64, int size,
                 bool fast_scale, unsigned char* out /* size*size*3 */) {
  std::vector<unsigned char> jpeg_buf;
  if (is_b64) {
    if (!base64_decode(data, len, &jpeg_buf)) return false;
    data = jpeg_buf.data();
    len = jpeg_buf.size();
  }
  std::vector<unsigned char> rgb;
  int w, h;
  if (!decode_jpeg_rgb(data, len, &rgb, &w, &h, fast_scale ? size : 0))
    return false;

  // target: shorter side == size (torchvision Resize(int) semantics)
  int ow, oh;
  if (w <= h) {
    ow = size;
    oh = (int)((double)size * h / w);
  } else {
    oh = size;
    ow = (int)((double)size * w / h);
  }
  std::vector<float> f0(rgb.size());
  for (size_t i = 0; i < rgb.size(); i++) f0[i] = rgb[i];
  // horizontal pass, then transpose twice for the vertical pass
  std::vector<float> f1((size_t)h * ow * 3);
  resample_axis(f0.data(), h, w, f1.data(), ow);
  std::vector<float> f1t((size_t)ow * h * 3);
  transpose_rgb(f1.data(), h, ow, f1t.data());
  std::vector<float> f2((size_t)ow * oh * 3);
  resample_axis(f1t.data(), ow, h, f2.data(), oh);
  std::vector<float> img((size_t)oh * ow * 3);
  transpose_rgb(f2.data(), ow, oh, img.data());

  // center-crop origin, matching gitax.preprocess.center_crop which
  // uses Python round() = round-half-to-EVEN; std::nearbyint under the
  // default FE_TONEAREST mode matches (lround rounds half away from
  // zero and shifts the crop window one pixel on odd margins)
  int left = (int)std::nearbyint((ow - size) / 2.0);
  int top = (int)std::nearbyint((oh - size) / 2.0);
  if (left < 0) left = 0;
  if (top < 0) top = 0;
  for (int y = 0; y < size; y++) {
    const float* srow = img.data() + ((size_t)(y + top) * ow + left) * 3;
    unsigned char* drow = out + (size_t)y * size * 3;
    for (int x = 0; x < size * 3; x++) {
      float v = srow[x];
      v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
      drow[x] = (unsigned char)std::lround(v);
    }
  }
  return true;
}

// target (oh, ow) of gitax.preprocess.min_max_resize_size (the
// reference's MinMaxResizeForTest sizing, inference.py:34-54), computed
// from the ORIGINAL image dims.  Python's round() is banker's rounding
// -> nearbyint; `int(size * h / w)` truncates -> C cast.
void minmax_target(int w, int h, int min_size, int max_size, int* oh,
                   int* ow) {
  int size = min_size;
  double min_orig = (double)(w < h ? w : h);
  double max_orig = (double)(w < h ? h : w);
  if (max_orig / min_orig * size > (double)max_size)
    size = (int)std::nearbyint((double)max_size * min_orig / max_orig);
  if ((w <= h && w == size) || (h <= w && h == size)) {
    *oh = h;
    *ow = w;
    return;
  }
  if (w < h) {
    *oh = (int)((double)size * h / w);
    *ow = size;
  } else {
    *oh = size;
    *ow = (int)((double)size * w / h);
  }
}

// full chain for one MinMax image: jpeg/base64 -> aspect-preserving
// resize to the MinMax target (NO crop) -> uint8 RGB, ragged output
bool process_one_minmax(const unsigned char* data, size_t len, bool is_b64,
                        int min_size, int max_size, bool fast_scale,
                        std::vector<unsigned char>* out, int* out_h,
                        int* out_w) {
  std::vector<unsigned char> jpeg_buf;
  if (is_b64) {
    if (!base64_decode(data, len, &jpeg_buf)) return false;
    data = jpeg_buf.data();
    len = jpeg_buf.size();
  }
  std::vector<unsigned char> rgb;
  int w, h, orig_w, orig_h;
  // the short side only ever shrinks to <= min_size, so min_size is a
  // safe reduced-IDCT floor; the TARGET is computed from the ORIGINAL
  // dims (reduced dims are ceil-divided and would drift the ratio)
  if (!decode_jpeg_rgb(data, len, &rgb, &w, &h, fast_scale ? min_size : 0,
                       &orig_w, &orig_h))
    return false;
  int oh, ow;
  minmax_target(orig_w, orig_h, min_size, max_size, &oh, &ow);
  *out_h = oh;
  *out_w = ow;

  std::vector<float> f0(rgb.size());
  for (size_t i = 0; i < rgb.size(); i++) f0[i] = rgb[i];
  std::vector<float> f1((size_t)h * ow * 3);
  resample_axis(f0.data(), h, w, f1.data(), ow);
  std::vector<float> f1t((size_t)ow * h * 3);
  transpose_rgb(f1.data(), h, ow, f1t.data());
  std::vector<float> f2((size_t)ow * oh * 3);
  resample_axis(f1t.data(), ow, h, f2.data(), oh);
  std::vector<float> img((size_t)oh * ow * 3);
  transpose_rgb(f2.data(), ow, oh, img.data());

  out->resize((size_t)oh * ow * 3);
  for (size_t i = 0; i < out->size(); i++) {
    float v = img[i];
    v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
    (*out)[i] = (unsigned char)std::lround(v);
  }
  return true;
}

// ------------------------------------------------------------- py module
// decode_resize_crop_batch(payloads: list[bytes], size: int,
//                          is_base64: bool, threads: int)
//   -> (buffer: bytes [N*size*size*3], ok_mask: list[bool])
PyObject* decode_resize_crop_batch(PyObject*, PyObject* args) {
  PyObject* payloads;
  int size, is_b64, threads, fast_scale;
  if (!PyArg_ParseTuple(args, "Oipip", &payloads, &size, &is_b64, &threads,
                        &fast_scale))
    return nullptr;
  if (!PyList_Check(payloads)) {
    PyErr_SetString(PyExc_TypeError, "payloads must be a list of bytes");
    return nullptr;
  }
  Py_ssize_t n = PyList_Size(payloads);
  std::vector<const unsigned char*> datas(n);
  std::vector<size_t> lens(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PyList_GetItem(payloads, i);
    char* buf;
    Py_ssize_t blen;
    if (PyBytes_AsStringAndSize(item, &buf, &blen) < 0) return nullptr;
    datas[i] = reinterpret_cast<unsigned char*>(buf);
    lens[i] = (size_t)blen;
  }
  size_t per = (size_t)size * size * 3;
  std::vector<unsigned char> out((size_t)n * per);
  std::vector<unsigned char> ok(n, 0);

  Py_BEGIN_ALLOW_THREADS;
  int nt = threads < 1 ? 1 : threads;
  std::vector<std::thread> pool;
  std::vector<Py_ssize_t> next_idx(1, 0);
  auto worker = [&](int tid) {
    for (Py_ssize_t i = tid; i < n; i += nt) {
      ok[i] = process_one(datas[i], lens[i], is_b64 != 0, size,
                          fast_scale != 0, out.data() + (size_t)i * per)
                  ? 1
                  : 0;
    }
  };
  for (int t = 0; t < nt; t++) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
  Py_END_ALLOW_THREADS;

  PyObject* buf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out.data()), (Py_ssize_t)out.size());
  PyObject* mask = PyList_New(n);
  for (Py_ssize_t i = 0; i < n; i++)
    PyList_SetItem(mask, i, PyBool_FromLong(ok[i]));
  PyObject* result = PyTuple_Pack(2, buf, mask);
  Py_DECREF(buf);
  Py_DECREF(mask);
  return result;
}

// decode_minmax_batch(payloads, min_size, max_size, is_base64, threads,
//                     fast_scale) -> list[(bytes, h, w) | None]
// Ragged outputs: each image resizes to its own MinMax target.
PyObject* decode_minmax_batch(PyObject*, PyObject* args) {
  PyObject* payloads;
  int min_size, max_size, is_b64, threads, fast_scale;
  if (!PyArg_ParseTuple(args, "Oiipip", &payloads, &min_size, &max_size,
                        &is_b64, &threads, &fast_scale))
    return nullptr;
  if (!PyList_Check(payloads)) {
    PyErr_SetString(PyExc_TypeError, "payloads must be a list of bytes");
    return nullptr;
  }
  Py_ssize_t n = PyList_Size(payloads);
  std::vector<const unsigned char*> datas(n);
  std::vector<size_t> lens(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PyList_GetItem(payloads, i);
    char* buf;
    Py_ssize_t blen;
    if (PyBytes_AsStringAndSize(item, &buf, &blen) < 0) return nullptr;
    datas[i] = reinterpret_cast<unsigned char*>(buf);
    lens[i] = (size_t)blen;
  }
  std::vector<std::vector<unsigned char>> outs(n);
  std::vector<int> hs(n, 0), ws(n, 0);
  std::vector<unsigned char> ok(n, 0);

  Py_BEGIN_ALLOW_THREADS;
  int nt = threads < 1 ? 1 : threads;
  std::vector<std::thread> pool;
  auto worker = [&](int tid) {
    for (Py_ssize_t i = tid; i < n; i += nt) {
      ok[i] = process_one_minmax(datas[i], lens[i], is_b64 != 0, min_size,
                                 max_size, fast_scale != 0, &outs[i], &hs[i],
                                 &ws[i])
                  ? 1
                  : 0;
    }
  };
  for (int t = 0; t < nt; t++) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
  Py_END_ALLOW_THREADS;

  PyObject* result = PyList_New(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!ok[i]) {
      Py_INCREF(Py_None);
      PyList_SetItem(result, i, Py_None);
      continue;
    }
    PyObject* buf = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(outs[i].data()),
        (Py_ssize_t)outs[i].size());
    // "N" steals buf's reference; plain PyTuple_Pack would leak the ints
    PyObject* tup = Py_BuildValue("(Nii)", buf, hs[i], ws[i]);
    PyList_SetItem(result, i, tup);
  }
  return result;
}

// b64_to_jpeg(payload: bytes) -> bytes | None
PyObject* b64_decode_py(PyObject*, PyObject* args) {
  const char* data;
  Py_ssize_t len;
  if (!PyArg_ParseTuple(args, "y#", &data, &len)) return nullptr;
  std::vector<unsigned char> out;
  if (!base64_decode(reinterpret_cast<const unsigned char*>(data), (size_t)len,
                     &out))
    Py_RETURN_NONE;
  return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(out.data()),
                                   (Py_ssize_t)out.size());
}

PyMethodDef methods[] = {
    {"decode_resize_crop_batch", decode_resize_crop_batch, METH_VARARGS,
     "batched base64/jpeg -> resized center-cropped uint8 RGB"},
    {"decode_minmax_batch", decode_minmax_batch, METH_VARARGS,
     "batched base64/jpeg -> MinMax aspect-preserving uint8 RGB (ragged)"},
    {"b64_decode", b64_decode_py, METH_VARARGS, "fast base64 decode"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_gitax_torch_native", nullptr, -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__gitax_torch_native(void) { return PyModule_Create(&moduledef); }
