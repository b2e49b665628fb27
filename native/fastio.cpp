/*
 * tpuflow._fastio — native IO runtime for frame streaming.
 *
 * Equivalent of the reference's host/streaming side: the
 * $readmemh frame codec (reference rtl/common/frame_buffer_simple.sv:41-48
 * loads .mem files; python tooling writes them line-by-line) and a
 * double-buffered frame prefetcher (the host analog of the RTL's
 * streaming pixel interface, frame_buffer_simple.sv:60-94 — one frame in
 * flight while the previous is consumed).
 *
 * Plain CPython C API (no pybind11 in this image). All file IO and
 * conversion loops release the GIL.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// .mem codec ($readmemh: one 2-hex-digit byte per line)
// ---------------------------------------------------------------------------

int hex_val(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

// Parse $readmemh text into bytes. Skips whitespace and //-comments.
bool decode_mem_text(const char* text, size_t len, std::vector<uint8_t>* out) {
  size_t i = 0;
  while (i < len) {
    char c = text[i];
    if (c == '/' && i + 1 < len && text[i + 1] == '/') {
      while (i < len && text[i] != '\n') i++;
      continue;
    }
    int hi = hex_val(c);
    if (hi >= 0) {
      if (i + 1 >= len) return false;
      int lo = hex_val(text[i + 1]);
      if (lo < 0) return false;
      out->push_back(static_cast<uint8_t>((hi << 4) | lo));
      i += 2;
      continue;
    }
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      i++;
      continue;
    }
    return false;  // unexpected character (e.g. X values)
  }
  return true;
}

bool read_file(const std::string& path, std::vector<char>* buf) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  buf->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(buf->data(), 1, buf->size(), f) : 0;
  std::fclose(f);
  return got == buf->size();
}

PyObject* py_decode_mem(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

  std::vector<char> text;
  std::vector<uint8_t> bytes;
  bool ok_read, ok_parse = false;
  Py_BEGIN_ALLOW_THREADS;
  ok_read = read_file(path, &text);
  if (ok_read) ok_parse = decode_mem_text(text.data(), text.size(), &bytes);
  Py_END_ALLOW_THREADS;

  if (!ok_read) {
    PyErr_Format(PyExc_FileNotFoundError, "cannot read %s", path);
    return nullptr;
  }
  if (!ok_parse) {
    PyErr_Format(PyExc_ValueError, "malformed .mem file: %s", path);
    return nullptr;
  }
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(bytes.data()),
      static_cast<Py_ssize_t>(bytes.size()));
}

PyObject* py_encode_mem(PyObject*, PyObject* args) {
  const char* path;
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "sy*", &path, &view)) return nullptr;

  bool ok = false;
  Py_BEGIN_ALLOW_THREADS;
  FILE* f = std::fopen(path, "wb");
  if (f) {
    const uint8_t* data = static_cast<const uint8_t*>(view.buf);
    std::string out;
    out.reserve(static_cast<size_t>(view.len) * 3);
    static const char* digits = "0123456789abcdef";
    for (Py_ssize_t i = 0; i < view.len; i++) {
      out.push_back(digits[data[i] >> 4]);
      out.push_back(digits[data[i] & 0xf]);
      out.push_back('\n');
    }
    ok = std::fwrite(out.data(), 1, out.size(), f) == out.size();
    std::fclose(f);
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&view);

  if (!ok) {
    PyErr_Format(PyExc_OSError, "cannot write %s", path);
    return nullptr;
  }
  Py_RETURN_NONE;
}

// u8 file -> float32 buffer (the frame load + dtype conversion the
// verifier does per pattern, optical_flow_verifier.py:61-65).
PyObject* py_load_bin_f32(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

  std::vector<char> raw;
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = read_file(path, &raw);
  Py_END_ALLOW_THREADS;
  if (!ok) {
    PyErr_Format(PyExc_FileNotFoundError, "cannot read %s", path);
    return nullptr;
  }

  PyObject* out = PyBytes_FromStringAndSize(nullptr,
      static_cast<Py_ssize_t>(raw.size() * sizeof(float)));
  if (!out) return nullptr;
  float* dst = reinterpret_cast<float*>(PyBytes_AS_STRING(out));
  Py_BEGIN_ALLOW_THREADS;
  for (size_t i = 0; i < raw.size(); i++) {
    dst[i] = static_cast<float>(static_cast<uint8_t>(raw[i]));
  }
  Py_END_ALLOW_THREADS;
  return out;
}

// ---------------------------------------------------------------------------
// FramePrefetcher: background thread reads frames ahead of the consumer.
// ---------------------------------------------------------------------------

struct Prefetcher {
  PyObject_HEAD
  std::vector<std::string> paths;
  size_t depth = 2;
  bool to_f32 = true;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<std::pair<size_t, std::vector<char>>> ready;  // (index, payload)
  size_t next_to_read = 0;     // worker position
  size_t next_to_consume = 0;  // consumer position
  std::atomic<bool> stop{false};
  std::string error;

  void run() {
    for (size_t i = 0; i < paths.size() && !stop.load(); i++) {
      std::vector<char> raw;
      if (!read_file(paths[i], &raw)) {
        std::lock_guard<std::mutex> lock(mu);
        error = "cannot read " + paths[i];
        cv_consume.notify_all();
        return;
      }
      std::vector<char> payload;
      if (to_f32) {
        payload.resize(raw.size() * sizeof(float));
        float* dst = reinterpret_cast<float*>(payload.data());
        for (size_t j = 0; j < raw.size(); j++) {
          dst[j] = static_cast<float>(static_cast<uint8_t>(raw[j]));
        }
      } else {
        payload = std::move(raw);
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_produce.wait(lock, [&] { return ready.size() < depth || stop.load(); });
      if (stop.load()) return;
      ready.emplace_back(i, std::move(payload));
      cv_consume.notify_all();
    }
  }
};

PyObject* prefetcher_new(PyTypeObject* type, PyObject*, PyObject*) {
  Prefetcher* self = reinterpret_cast<Prefetcher*>(type->tp_alloc(type, 0));
  if (self) {
    new (&self->paths) std::vector<std::string>();
    new (&self->worker) std::thread();
    new (&self->mu) std::mutex();
    new (&self->cv_produce) std::condition_variable();
    new (&self->cv_consume) std::condition_variable();
    new (&self->ready) std::deque<std::pair<size_t, std::vector<char>>>();
    new (&self->error) std::string();
    self->stop.store(false);
  }
  return reinterpret_cast<PyObject*>(self);
}

int prefetcher_init(PyObject* obj, PyObject* args, PyObject* kwargs) {
  Prefetcher* self = reinterpret_cast<Prefetcher*>(obj);
  PyObject* path_list;
  Py_ssize_t depth = 2;
  int to_f32 = 1;
  static const char* kwlist[] = {"paths", "depth", "to_float32", nullptr};
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "O|np", const_cast<char**>(kwlist), &path_list,
          &depth, &to_f32)) {
    return -1;
  }
  PyObject* seq = PySequence_Fast(path_list, "paths must be a sequence");
  if (!seq) return -1;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    PyObject* str = PyObject_Str(item);
    if (!str) {
      Py_DECREF(seq);
      return -1;
    }
    self->paths.emplace_back(PyUnicode_AsUTF8(str));
    Py_DECREF(str);
  }
  Py_DECREF(seq);
  self->depth = static_cast<size_t>(depth > 0 ? depth : 1);
  self->to_f32 = to_f32 != 0;
  self->worker = std::thread([self] { self->run(); });
  return 0;
}

void prefetcher_shutdown(Prefetcher* self) {
  self->stop.store(true);
  self->cv_produce.notify_all();
  if (self->worker.joinable()) self->worker.join();
}

void prefetcher_dealloc(PyObject* obj) {
  Prefetcher* self = reinterpret_cast<Prefetcher*>(obj);
  prefetcher_shutdown(self);
  self->paths.~vector();
  self->worker.~thread();
  self->mu.~mutex();
  self->cv_produce.~condition_variable();
  self->cv_consume.~condition_variable();
  self->ready.~deque();
  self->error.~basic_string();
  Py_TYPE(obj)->tp_free(obj);
}

PyObject* prefetcher_next_frame(PyObject* obj, PyObject*) {
  Prefetcher* self = reinterpret_cast<Prefetcher*>(obj);
  if (self->next_to_consume >= self->paths.size()) {
    Py_RETURN_NONE;  // exhausted
  }
  std::vector<char> payload;
  {
    std::unique_lock<std::mutex> lock(self->mu);
    bool got = false;
    Py_BEGIN_ALLOW_THREADS;
    self->cv_consume.wait(lock, [&] {
      return !self->ready.empty() || !self->error.empty();
    });
    Py_END_ALLOW_THREADS;
    if (!self->error.empty()) {
      PyErr_SetString(PyExc_OSError, self->error.c_str());
      return nullptr;
    }
    payload = std::move(self->ready.front().second);
    self->ready.pop_front();
    got = true;
    (void)got;
    self->cv_produce.notify_all();
  }
  self->next_to_consume++;
  return PyBytes_FromStringAndSize(payload.data(),
                                   static_cast<Py_ssize_t>(payload.size()));
}

PyObject* prefetcher_close(PyObject* obj, PyObject*) {
  prefetcher_shutdown(reinterpret_cast<Prefetcher*>(obj));
  Py_RETURN_NONE;
}

PyMethodDef prefetcher_methods[] = {
    {"next_frame", prefetcher_next_frame, METH_NOARGS,
     "Blocking fetch of the next frame payload (bytes); None when done."},
    {"close", prefetcher_close, METH_NOARGS, "Stop the worker thread."},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject PrefetcherType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

PyMethodDef module_methods[] = {
    {"decode_mem", py_decode_mem, METH_VARARGS,
     "decode_mem(path) -> bytes of pixel values ($readmemh format)."},
    {"encode_mem", py_encode_mem, METH_VARARGS,
     "encode_mem(path, data: bytes-like) -> None."},
    {"load_bin_f32", py_load_bin_f32, METH_VARARGS,
     "load_bin_f32(path) -> bytes of float32 (u8 file widened)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef fastio_module = {
    PyModuleDef_HEAD_INIT, "_fastio",
    "tpuflow native IO runtime (mem codec + frame prefetcher)", -1,
    module_methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastio(void) {
  PrefetcherType.tp_name = "tpuflow._fastio.FramePrefetcher";
  PrefetcherType.tp_basicsize = sizeof(Prefetcher);
  PrefetcherType.tp_flags = Py_TPFLAGS_DEFAULT;
  PrefetcherType.tp_doc = "Background-thread frame prefetcher.";
  PrefetcherType.tp_new = prefetcher_new;
  PrefetcherType.tp_init = prefetcher_init;
  PrefetcherType.tp_dealloc = prefetcher_dealloc;
  PrefetcherType.tp_methods = prefetcher_methods;
  if (PyType_Ready(&PrefetcherType) < 0) return nullptr;

  PyObject* m = PyModule_Create(&fastio_module);
  if (!m) return nullptr;
  Py_INCREF(&PrefetcherType);
  PyModule_AddObject(m, "FramePrefetcher",
                     reinterpret_cast<PyObject*>(&PrefetcherType));
  return m;
}
