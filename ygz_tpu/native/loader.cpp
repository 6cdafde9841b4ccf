// ygz_native — native dataset runtime: PNG grayscale decode + threaded
// prefetch.
//
// The reference's dataset mains decode images synchronously on the tracking
// thread (cv::imread in Examples/*/mono_*.cc); at accelerator tracking
// rates Python-side PIL decoding can become the bottleneck. This module provides:
//   * decode_png_gray(path)            -> (bytes, h, w) 8-bit grayscale
//   * Prefetcher(paths, ahead, threads) -> .get(i) -> (bytes, h, w)
//     a worker pool that decodes frames ahead of the consumer, keeping the
//     device pipeline fed (the native analog of the reference's
//     producer/consumer threading).
//
// Python-facing fallback: ygz_tpu/native/__init__.py builds this lazily with
// g++ and falls back to PIL when the toolchain is unavailable.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <png.h>

#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct GrayImage {
  std::vector<unsigned char> pixels;
  int h = 0, w = 0;
  bool ok = false;
  std::string err;
};

GrayImage decode_png_gray_impl(const char* path) {
  GrayImage out;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    out.err = "cannot open file";
    return out;
  }
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    out.err = "not a PNG";
    return out;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    out.err = "libpng init failed";
    return out;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    out.err = "libpng decode error";
    return out;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);  // ITU-R 709-ish weights
  png_read_update_info(png, info);

  out.pixels.resize(static_cast<size_t>(w) * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out.pixels.data() + static_cast<size_t>(y) * w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  out.h = static_cast<int>(h);
  out.w = static_cast<int>(w);
  out.ok = true;
  return out;
}

PyObject* image_to_tuple(const GrayImage& img) {
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(img.pixels.data()),
      static_cast<Py_ssize_t>(img.pixels.size()));
  if (!bytes) return nullptr;
  PyObject* tup = Py_BuildValue("(Nii)", bytes, img.h, img.w);
  return tup;
}

PyObject* py_decode_png_gray(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  GrayImage img;
  Py_BEGIN_ALLOW_THREADS
  img = decode_png_gray_impl(path);
  Py_END_ALLOW_THREADS
  if (!img.ok) {
    PyErr_Format(PyExc_IOError, "decode_png_gray(%s): %s", path,
                 img.err.c_str());
    return nullptr;
  }
  return image_to_tuple(img);
}

// ----------------------------------------------------------------- Prefetcher

struct PrefetchState {
  std::vector<std::string> paths;
  std::map<size_t, GrayImage> ready;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  size_t next_to_decode = 0;
  size_t consumer_pos = 0;
  size_t ahead = 8;
  bool stop = false;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop || (next_to_decode < paths.size() &&
                          next_to_decode < consumer_pos + ahead);
        });
        if (stop) return;
        idx = next_to_decode++;
      }
      GrayImage img = decode_png_gray_impl(paths[idx].c_str());
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(idx, std::move(img));
      }
      cv.notify_all();
    }
  }

  void shutdown() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }
};

// NOTE: the C++ state lives behind a pointer — placement-new over the whole
// Python object would wipe ob_type/refcount set by tp_alloc.
struct Prefetcher {
  PyObject_HEAD
  PrefetchState* st;
};

void prefetcher_dealloc(PyObject* self) {
  auto* p = reinterpret_cast<Prefetcher*>(self);
  if (p->st) {
    Py_BEGIN_ALLOW_THREADS
    p->st->shutdown();
    Py_END_ALLOW_THREADS
    delete p->st;
    p->st = nullptr;
  }
  Py_TYPE(self)->tp_free(self);
}

PyObject* prefetcher_new(PyTypeObject* type, PyObject*, PyObject*) {
  PyObject* self = type->tp_alloc(type, 0);
  if (self) reinterpret_cast<Prefetcher*>(self)->st = nullptr;
  return self;
}

int prefetcher_init(PyObject* self, PyObject* args, PyObject*) {
  auto* p = reinterpret_cast<Prefetcher*>(self);
  PyObject* list;
  int ahead = 8, threads = 2;
  if (!PyArg_ParseTuple(args, "O|ii", &list, &ahead, &threads)) return -1;
  PyObject* seq = PySequence_Fast(list, "paths must be a sequence");
  if (!seq) return -1;
  auto* st = new PrefetchState();
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* it = PySequence_Fast_GET_ITEM(seq, i);
    const char* s = PyUnicode_AsUTF8(it);
    if (!s) {
      Py_DECREF(seq);
      delete st;
      return -1;
    }
    st->paths.emplace_back(s);
  }
  Py_DECREF(seq);
  st->ahead = static_cast<size_t>(ahead > 1 ? ahead : 1);
  for (int i = 0; i < (threads > 1 ? threads : 1); ++i)
    st->workers.emplace_back(&PrefetchState::worker, st);
  if (p->st) {
    p->st->shutdown();
    delete p->st;
  }
  p->st = st;
  return 0;
}

PyObject* prefetcher_get(PyObject* self, PyObject* args) {
  auto* p0 = reinterpret_cast<Prefetcher*>(self);
  if (!p0->st) {
    PyErr_SetString(PyExc_RuntimeError, "prefetcher not initialized");
    return nullptr;
  }
  auto* p = p0->st;
  Py_ssize_t idx;
  if (!PyArg_ParseTuple(args, "n", &idx)) return nullptr;
  if (idx < 0 || static_cast<size_t>(idx) >= p->paths.size()) {
    PyErr_SetString(PyExc_IndexError, "prefetcher index out of range");
    return nullptr;
  }
  GrayImage img;
  Py_BEGIN_ALLOW_THREADS {
    std::unique_lock<std::mutex> lk(p->mu);
    p->consumer_pos = static_cast<size_t>(idx);
    p->cv.notify_all();
    p->cv.wait(lk, [&] { return p->ready.count(idx) > 0; });
    img = std::move(p->ready[idx]);
    p->ready.erase(idx);
    // drop stale entries behind the consumer
    for (auto it = p->ready.begin();
         it != p->ready.end() && it->first < static_cast<size_t>(idx);)
      it = p->ready.erase(it);
  }
  Py_END_ALLOW_THREADS
  if (!img.ok) {
    PyErr_Format(PyExc_IOError, "prefetch decode failed: %s", img.err.c_str());
    return nullptr;
  }
  return image_to_tuple(img);
}

PyMethodDef prefetcher_methods[] = {
    {"get", prefetcher_get, METH_VARARGS,
     "get(i) -> (bytes, h, w): blocking fetch of frame i"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject PrefetcherType = [] {
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "ygz_native.Prefetcher";
  t.tp_basicsize = sizeof(Prefetcher);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "threaded PNG prefetch decoder";
  t.tp_new = prefetcher_new;
  t.tp_init = prefetcher_init;
  t.tp_dealloc = prefetcher_dealloc;
  t.tp_methods = prefetcher_methods;
  return t;
}();

PyMethodDef module_methods[] = {
    {"decode_png_gray", py_decode_png_gray, METH_VARARGS,
     "decode_png_gray(path) -> (bytes, h, w) 8-bit grayscale"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "ygz_native",
                         "native dataset runtime", -1, module_methods};

}  // namespace

PyMODINIT_FUNC PyInit_ygz_native(void) {
  if (PyType_Ready(&PrefetcherType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&moduledef);
  if (!m) return nullptr;
  Py_INCREF(&PrefetcherType);
  PyModule_AddObject(m, "Prefetcher",
                     reinterpret_cast<PyObject*>(&PrefetcherType));
  return m;
}
