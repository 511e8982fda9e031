// needle-tpu C API served by needle_tpu_torch (PyTorch on a CUDA card).
//
// Implements every function of capi/needle_tpu.h, included read-only, with
// the structure of capi/needle_tpu_capi.cpp: a thin C++ layer embedding
// CPython, whose opaque handles hold strong references to the Python
// Analyzer/Comparator objects of needle_tpu_torch. Every entry point takes
// the GIL, so the library is callable from any thread. Argument checks,
// error strings, the exception-to-NeedleError mapping and the default
// arguments are those of the needle_tpu library.
//
// The header has no device argument: NEEDLE_TPU_TORCH_DEVICE ("cuda", the
// default, or "cpu") is passed as `device=` to Analyzer.from_files and
// Comparator.from_files; any other value makes the constructors return
// NeedleError_InvalidArgument. Asking for "cuda" without a card makes the
// run functions return an error code: nothing falls back to the CPU.
//
// The package is found through NEEDLE_TPU_PYTHON_ROOT, else through the
// nearest ancestor of this library's directory that holds
// needle_tpu_torch/__init__.py (the library is built under
// needle_tpu_torch/_build/).

#include "needle_tpu.h"

#include <Python.h>

#include <dlfcn.h>
#include <unistd.h>

#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

const char kPackage[] = "needle_tpu_torch";

std::mutex g_init_mutex;
bool g_initialized = false;

// Directory containing this shared library.
std::string self_dir() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void *>(&needle_error_to_str), &info) &&
      info.dli_fname) {
    std::string p(info.dli_fname);
    auto pos = p.find_last_of('/');
    if (pos != std::string::npos) return p.substr(0, pos);
  }
  return ".";
}

// The nearest ancestor of this library's directory (itself included) that
// holds the package; empty if there is none within a few levels.
std::string package_root() {
  std::string dir = self_dir();
  for (int level = 0; level < 6; level++) {
    std::string init = dir + "/" + kPackage + "/__init__.py";
    if (access(init.c_str(), R_OK) == 0) return dir;
    dir += "/..";
  }
  return "";
}

// The torch device for new handles from NEEDLE_TPU_TORCH_DEVICE: "cuda"
// when unset, nullptr for a value other than "cuda" or "cpu".
const char *torch_device() {
  const char *v = getenv("NEEDLE_TPU_TORCH_DEVICE");
  if (!v) return "cuda";
  if (!strcmp(v, "cuda") || !strcmp(v, "cpu")) return v;
  return nullptr;
}

// Initialize the embedded interpreter once and import needle_tpu_torch.
// Returns false (with the error latched) on failure.
bool ensure_python() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_initialized) return true;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    // Release the GIL acquired by initialization; every API call uses
    // PyGILState_Ensure from here on.
    PyEval_SaveThread();
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  bool ok = false;
  {
    PyObject *sys_path = PySys_GetObject("path");  // borrowed
    const char *env_root = getenv("NEEDLE_TPU_PYTHON_ROOT");
    std::vector<std::string> roots;
    if (env_root) roots.push_back(env_root);
    std::string root = package_root();
    if (!root.empty()) roots.push_back(root);
    for (const auto &r : roots) {
      PyObject *s = PyUnicode_FromString(r.c_str());
      if (s) {
        PyList_Append(sys_path, s);
        Py_DECREF(s);
      }
    }
    PyObject *mod = PyImport_ImportModule("needle_tpu_torch");
    if (mod) {
      Py_DECREF(mod);
      ok = true;
    } else {
      PyErr_Print();
    }
  }
  PyGILState_Release(gil);
  g_initialized = ok;
  return ok;
}

// Map a raised Python exception (already set) to a NeedleError; clears it.
NeedleError error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  NeedleError err = NeedleError_Unknown;
  if (type) {
    PyObject *name_obj = PyObject_GetAttrString(type, "__name__");
    const char *name = name_obj ? PyUnicode_AsUTF8(name_obj) : "";
    if (name) {
      if (!strcmp(name, "FrameHashDataNotFound"))
        err = NeedleError_FrameHashDataNotFound;
      else if (!strcmp(name, "FrameHashDataInvalidVersion"))
        err = NeedleError_FrameHashDataInvalidVersion;
      else if (!strcmp(name, "FrameHashDataNoEnding"))
        err = NeedleError_InvalidFrameHashData;
      else if (!strcmp(name, "AnalyzerMissingPaths"))
        err = NeedleError_InvalidArgument;
      else if (!strcmp(name, "PathNotFound"))
        err = NeedleError_IOError;
      else if (!strcmp(name, "ComparatorMinimumPaths"))
        err = NeedleError_ComparatorMinimumPaths;
      else if (!strcmp(name, "OSError") || !strcmp(name, "IOError") ||
               !strcmp(name, "FileNotFoundError"))
        err = NeedleError_IOError;
      else if (!strcmp(name, "ValueError") || !strcmp(name, "TypeError"))
        err = NeedleError_InvalidArgument;
      else if (!strcmp(name, "UnicodeDecodeError"))
        err = NeedleError_InvalidUtf8String;
    }
    Py_XDECREF(name_obj);
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return err;
}

// Build a Python list[str] from C paths; returns nullptr + error on bad UTF-8.
PyObject *paths_to_list(const char *const *paths, size_t num_paths,
                        NeedleError *err) {
  PyObject *list = PyList_New(static_cast<Py_ssize_t>(num_paths));
  if (!list) {
    *err = NeedleError_Unknown;
    return nullptr;
  }
  for (size_t i = 0; i < num_paths; i++) {
    if (!paths[i]) {
      Py_DECREF(list);
      *err = NeedleError_NullArgument;
      return nullptr;
    }
    PyObject *s = PyUnicode_FromString(paths[i]);
    if (!s) {
      PyErr_Clear();
      Py_DECREF(list);
      *err = NeedleError_InvalidUtf8String;
      return nullptr;
    }
    PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), s);
  }
  return list;
}

PyObject *get_library_attr(const char *name) {
  PyObject *mod = PyImport_ImportModule("needle_tpu_torch");
  if (!mod) return nullptr;
  PyObject *attr = PyObject_GetAttrString(mod, name);
  Py_DECREF(mod);
  return attr;
}

// cls.from_files(*args, device=device); nullptr with the error set on
// failure.
PyObject *from_files(const char *cls_name, PyObject *args,
                     const char *device) {
  PyObject *cls = get_library_attr(cls_name);
  if (!cls) return nullptr;
  PyObject *fn = PyObject_GetAttrString(cls, "from_files");
  Py_DECREF(cls);
  if (!fn) return nullptr;
  PyObject *kwargs = Py_BuildValue("{s:s}", "device", device);
  PyObject *obj = kwargs ? PyObject_Call(fn, args, kwargs) : nullptr;
  Py_XDECREF(kwargs);
  Py_DECREF(fn);
  return obj;
}

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

}  // namespace

// Opaque handle bodies.
struct NeedleAudioAnalyzer {
  PyObject *obj;           // needle_tpu_torch.Analyzer
  PyObject *frame_hashes;  // list[FrameHashes] from the last run (or NULL)
};

struct NeedleAudioComparator {
  PyObject *obj;  // needle_tpu_torch.Comparator
};

extern "C" {

const char *needle_error_to_str(enum NeedleError error) {
  switch (error) {
    case NeedleError_Ok:
      return "no error";
    case NeedleError_InvalidUtf8String:
      return "invalid UTF-8 string";
    case NeedleError_NullArgument:
      return "one or more arguments were NULL";
    case NeedleError_InvalidArgument:
      return "one or more arguments were invalid";
    case NeedleError_FrameHashDataNotFound:
      return "frame hash data not found on disk";
    case NeedleError_FrameHashDataInvalidVersion:
      return "frame hash data has an invalid version";
    case NeedleError_InvalidFrameHashData:
      return "invalid frame hash data";
    case NeedleError_ComparatorMinimumPaths:
      return "comparator requires at least 2 video paths";
    case NeedleError_AnalyzerInvalidHashPeriod:
      return "invalid hash period";
    case NeedleError_AnalyzerInvalidHashDuration:
      return "hash duration too short";
    case NeedleError_IOError:
      return "I/O error";
    case NeedleError_Unknown:
    default:
      return "unknown error";
  }
}

enum NeedleError needle_util_find_video_files(const char *const *paths,
                                              size_t num_paths, bool full,
                                              bool audio,
                                              const char *const **videos,
                                              size_t *num_videos) {
  if (!paths || !videos || !num_videos) return NeedleError_NullArgument;
  if (num_paths == 0) return NeedleError_InvalidArgument;
  if (!ensure_python()) return NeedleError_Unknown;
  GilGuard gil;

  NeedleError err = NeedleError_Ok;
  PyObject *list = paths_to_list(paths, num_paths, &err);
  if (!list) return err;

  PyObject *util = get_library_attr("util");
  PyObject *result = nullptr;
  if (util) {
    PyObject *fn = PyObject_GetAttrString(util, "find_video_files");
    if (fn) {
      result = PyObject_CallFunction(fn, "OOO", list, full ? Py_True : Py_False,
                                     audio ? Py_True : Py_False);
      Py_DECREF(fn);
    }
    Py_DECREF(util);
  }
  Py_DECREF(list);
  if (!result) return error_from_python();

  Py_ssize_t n = PySequence_Length(result);
  const char **out =
      static_cast<const char **>(calloc(static_cast<size_t>(n > 0 ? n : 1),
                                        sizeof(char *)));
  if (!out) {
    Py_DECREF(result);
    return NeedleError_Unknown;
  }
  Py_ssize_t kept = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PySequence_GetItem(result, i);
    // encode with surrogateescape so non-UTF-8 filenames survive the
    // round trip instead of crashing on a NULL from PyUnicode_AsUTF8
    PyObject *str = item ? PyObject_Str(item) : nullptr;
    PyObject *bytes = str ? PyUnicode_EncodeFSDefault(str) : nullptr;
    if (bytes) {
      out[kept++] = strdup(PyBytes_AsString(bytes));
      Py_DECREF(bytes);
    } else {
      PyErr_Clear();
    }
    Py_XDECREF(str);
    Py_XDECREF(item);
  }
  Py_DECREF(result);
  *videos = out;
  *num_videos = static_cast<size_t>(kept);
  return NeedleError_Ok;
}

void needle_util_video_files_free(const char *const *videos,
                                  size_t num_videos) {
  if (!videos) return;
  for (size_t i = 0; i < num_videos; i++)
    free(const_cast<char *>(videos[i]));
  free(const_cast<char **>(const_cast<const char **>(videos)));
}

enum NeedleError needle_audio_analyzer_new(
    const char *const *paths, size_t num_paths, float opening_search_percentage,
    float ending_search_percentage, bool include_endings, bool threaded_decoding,
    bool force, struct NeedleAudioAnalyzer **output) {
  if (!paths || !output) return NeedleError_NullArgument;
  if (num_paths == 0 || opening_search_percentage >= 1.0f ||
      ending_search_percentage >= 1.0f)
    return NeedleError_InvalidArgument;
  const char *device = torch_device();
  if (!device) return NeedleError_InvalidArgument;
  if (!ensure_python()) return NeedleError_Unknown;
  GilGuard gil;

  NeedleError err = NeedleError_Ok;
  PyObject *list = paths_to_list(paths, num_paths, &err);
  if (!list) return err;

  PyObject *args = Py_BuildValue("(OOO)", list,
                                 threaded_decoding ? Py_True : Py_False,
                                 force ? Py_True : Py_False);
  Py_DECREF(list);
  PyObject *obj = args ? from_files("Analyzer", args, device) : nullptr;
  Py_XDECREF(args);
  if (!obj) return error_from_python();

  // Configuration through the with_* methods.
  PyObject *r1 = PyObject_CallMethod(obj, "with_opening_search_percentage", "f",
                                     opening_search_percentage);
  PyObject *r2 = PyObject_CallMethod(obj, "with_ending_search_percentage", "f",
                                     ending_search_percentage);
  PyObject *r3 = PyObject_CallMethod(obj, "with_include_endings", "O",
                                     include_endings ? Py_True : Py_False);
  Py_XDECREF(r1);
  Py_XDECREF(r2);
  Py_XDECREF(r3);
  if (PyErr_Occurred()) {
    Py_DECREF(obj);
    return error_from_python();
  }

  auto *handle = new NeedleAudioAnalyzer{obj, nullptr};
  *output = handle;
  return NeedleError_Ok;
}

enum NeedleError needle_audio_analyzer_new_default(
    const char *const *paths, size_t num_paths,
    struct NeedleAudioAnalyzer **output) {
  // Defaults from needle_tpu_torch.constants (reference audio/mod.rs:19,24).
  return needle_audio_analyzer_new(paths, num_paths, 0.50f, 0.25f, false,
                                   false, false, output);
}

enum NeedleError needle_audio_analyzer_get_frame_hashes(
    const struct NeedleAudioAnalyzer *analyzer, size_t index,
    const struct FrameHashes **output) {
  if (!analyzer || !output) return NeedleError_NullArgument;
  GilGuard gil;
  if (!analyzer->frame_hashes)
    return NeedleError_InvalidArgument;  // run() not called yet
  Py_ssize_t n = PyList_Size(analyzer->frame_hashes);
  if (index >= static_cast<size_t>(n)) return NeedleError_InvalidArgument;
  // Borrowed from the list held by the analyzer handle; valid until free/run.
  PyObject *item = PyList_GetItem(analyzer->frame_hashes,
                                  static_cast<Py_ssize_t>(index));
  *output = reinterpret_cast<const struct FrameHashes *>(item);
  return NeedleError_Ok;
}

void needle_audio_analyzer_free(const struct NeedleAudioAnalyzer *analyzer) {
  if (!analyzer) return;
  GilGuard gil;
  auto *h = const_cast<NeedleAudioAnalyzer *>(analyzer);
  Py_XDECREF(h->obj);
  Py_XDECREF(h->frame_hashes);
  delete h;
}

void needle_audio_analyzer_print_paths(
    const struct NeedleAudioAnalyzer *analyzer) {
  if (!analyzer) return;
  GilGuard gil;
  PyObject *videos = PyObject_GetAttrString(analyzer->obj, "videos");
  if (!videos) {
    PyErr_Clear();
    return;
  }
  Py_ssize_t n = PySequence_Length(videos);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PySequence_GetItem(videos, i);
    PyObject *str = item ? PyObject_Str(item) : nullptr;
    const char *c = str ? PyUnicode_AsUTF8(str) : nullptr;
    if (c) printf("%s\n", c);
    else PyErr_Clear();
    Py_XDECREF(str);
    Py_XDECREF(item);
  }
  Py_DECREF(videos);
}

enum NeedleError needle_audio_analyzer_run(struct NeedleAudioAnalyzer *analyzer,
                                           float hash_duration, bool persist,
                                           bool threading) {
  if (!analyzer) return NeedleError_NullArgument;
  if (hash_duration <= 0.0f) return NeedleError_AnalyzerInvalidHashDuration;
  GilGuard gil;
  PyObject *result = PyObject_CallMethod(
      analyzer->obj, "run", "fOO", hash_duration, persist ? Py_True : Py_False,
      threading ? Py_True : Py_False);
  if (!result) return error_from_python();
  Py_XDECREF(analyzer->frame_hashes);
  analyzer->frame_hashes = PySequence_List(result);
  Py_DECREF(result);
  if (!analyzer->frame_hashes) return error_from_python();
  return NeedleError_Ok;
}

enum NeedleError needle_audio_comparator_new(
    const char *const *paths, size_t num_paths, bool include_endings,
    uint16_t hash_match_threshold, uint16_t min_opening_duration,
    uint16_t min_ending_duration, float time_padding,
    const struct NeedleAudioComparator **output) {
  if (!paths || !output) return NeedleError_NullArgument;
  if (num_paths < 2) return NeedleError_ComparatorMinimumPaths;
  if (hash_match_threshold > 32) return NeedleError_InvalidArgument;
  const char *device = torch_device();
  if (!device) return NeedleError_InvalidArgument;
  if (!ensure_python()) return NeedleError_Unknown;
  GilGuard gil;

  NeedleError err = NeedleError_Ok;
  PyObject *list = paths_to_list(paths, num_paths, &err);
  if (!list) return err;

  PyObject *args = PyTuple_Pack(1, list);
  Py_DECREF(list);
  PyObject *obj = args ? from_files("Comparator", args, device) : nullptr;
  Py_XDECREF(args);
  if (!obj) return error_from_python();

  PyObject *dur_cls = get_library_attr("Duration");
  PyObject *min_open =
      dur_cls ? PyObject_CallMethod(dur_cls, "from_secs", "i",
                                    static_cast<int>(min_opening_duration))
              : nullptr;
  PyObject *min_end =
      dur_cls ? PyObject_CallMethod(dur_cls, "from_secs", "i",
                                    static_cast<int>(min_ending_duration))
              : nullptr;
  PyObject *padding =
      dur_cls ? PyObject_CallMethod(dur_cls, "from_secs_f32", "f", time_padding)
              : nullptr;
  Py_XDECREF(dur_cls);

  PyObject *r1 = PyObject_CallMethod(obj, "with_include_endings", "O",
                                     include_endings ? Py_True : Py_False);
  PyObject *r2 = PyObject_CallMethod(obj, "with_hash_match_threshold", "i",
                                     static_cast<int>(hash_match_threshold));
  PyObject *r3 = min_open ? PyObject_CallMethod(obj, "with_min_opening_duration",
                                                "O", min_open)
                          : nullptr;
  PyObject *r4 = min_end ? PyObject_CallMethod(obj, "with_min_ending_duration",
                                               "O", min_end)
                         : nullptr;
  PyObject *r5 =
      padding ? PyObject_CallMethod(obj, "with_time_padding", "O", padding)
              : nullptr;
  Py_XDECREF(r1);
  Py_XDECREF(r2);
  Py_XDECREF(r3);
  Py_XDECREF(r4);
  Py_XDECREF(r5);
  Py_XDECREF(min_open);
  Py_XDECREF(min_end);
  Py_XDECREF(padding);
  if (PyErr_Occurred()) {
    Py_DECREF(obj);
    return error_from_python();
  }

  auto *handle = new NeedleAudioComparator{obj};
  *output = handle;
  return NeedleError_Ok;
}

enum NeedleError needle_audio_comparator_new_default(
    const char *const *paths, size_t num_paths,
    const struct NeedleAudioComparator **output) {
  return needle_audio_comparator_new(paths, num_paths, false, 10, 20, 20, 0.0f,
                                     output);
}

void needle_audio_comparator_free(
    const struct NeedleAudioComparator *comparator) {
  if (!comparator) return;
  GilGuard gil;
  auto *h = const_cast<NeedleAudioComparator *>(comparator);
  Py_XDECREF(h->obj);
  delete h;
}

enum NeedleError needle_audio_comparator_run(
    const struct NeedleAudioComparator *comparator, bool analyze, bool display,
    bool use_skip_files, bool write_skip_files, bool threading) {
  if (!comparator) return NeedleError_NullArgument;
  GilGuard gil;
  PyObject *result = PyObject_CallMethod(
      comparator->obj, "run", "OOOOO", analyze ? Py_True : Py_False,
      display ? Py_True : Py_False, use_skip_files ? Py_True : Py_False,
      write_skip_files ? Py_True : Py_False, threading ? Py_True : Py_False);
  if (!result) return error_from_python();
  Py_DECREF(result);
  return NeedleError_Ok;
}

}  // extern "C"
