/*
 * libzl_shim.cpp — C++ implementation of the libzl C ABI over the JAX engine.
 *
 * The reference implements this layer by marshalling every call onto a JUCE
 * message thread and poking tracktion/JACK singletons
 * (reference lib/libzl.cpp:39-135). Here the engine lives in an embedded
 * CPython interpreter running libzl_tpu; each C entry point acquires the GIL
 * and calls the matching function in libzl_tpu.capi.bridge. The interpreter
 * is initialised lazily by initJuce() on its own thread so the embedding
 * application keeps its main loop, mirroring the reference's JuceEventLoop
 * thread boundary (lib/libzl.cpp:44-102).
 *
 * Clip handles: the bridge hands out integer ids; this layer packs them into
 * the opaque ClipAudioSource* (id 0 is never allocated, so NULL stays
 * falsy). ClipAudioSource_byID therefore needs no table on the C++ side.
 *
 * Build: see Makefile / CMakeLists.txt in this directory.
 */

#include "libzl.h"

#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <mutex>
#include <string>

namespace {

std::atomic<bool> g_initialized{false};
std::mutex g_init_mutex;
PyObject *g_bridge = nullptr;       // libzl_tpu.capi.bridge module
PyThreadState *g_main_state = nullptr;

// last string returned by getFileName (the reference returns a pointer into
// its own storage too, lib/ClipAudioSource getFileName semantics)
thread_local std::string g_filename_storage;

struct Gil {
  PyGILState_STATE state;
  Gil() : state(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state); }
};

void report_python_error(const char *where) {
  std::fprintf(stderr, "libzl: python error in %s\n", where);
  PyErr_Print();
}

// Call bridge.<name>(args...) with a printf-ish format understood by
// Py_BuildValue; returns a new reference or nullptr.
PyObject *call(const char *name, const char *fmt, ...) {
  if (!g_initialized.load()) {
    std::fprintf(stderr, "libzl: %s called before initJuce()\n", name);
    return nullptr;
  }
  Gil gil;
  PyObject *fn = PyObject_GetAttrString(g_bridge, name);
  if (fn == nullptr) {
    report_python_error(name);
    return nullptr;
  }
  PyObject *args = nullptr;
  if (fmt != nullptr && fmt[0] != '\0') {
    va_list va;
    va_start(va, fmt);
    args = Py_VaBuildValue(fmt, va);
    va_end(va);
    if (args != nullptr && !PyTuple_Check(args)) {
      PyObject *tuple = PyTuple_Pack(1, args);
      Py_DECREF(args);
      args = tuple;
    }
  } else {
    args = PyTuple_New(0);
  }
  PyObject *result = args ? PyObject_CallObject(fn, args) : nullptr;
  Py_XDECREF(args);
  Py_DECREF(fn);
  if (result == nullptr) {
    report_python_error(name);
  }
  return result;
}

// NOTE: every refcount/conversion on a call() result must hold the GIL —
// call() releases it when returning.
double as_double(PyObject *obj, double fallback = 0.0) {
  if (obj == nullptr) return fallback;
  Gil gil;
  double v = PyFloat_AsDouble(obj);
  Py_DECREF(obj);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    return fallback;
  }
  return v;
}

long as_long(PyObject *obj, long fallback = 0) {
  if (obj == nullptr) return fallback;
  Gil gil;
  long v = PyLong_AsLong(obj);
  Py_DECREF(obj);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    return fallback;
  }
  return v;
}

void discard(PyObject *obj) {
  if (obj == nullptr) return;
  Gil gil;
  Py_DECREF(obj);
}

inline int clip_id(ClipAudioSource *c) {
  return static_cast<int>(reinterpret_cast<intptr_t>(c));
}

inline ClipAudioSource *clip_handle(long id) {
  return reinterpret_cast<ClipAudioSource *>(static_cast<intptr_t>(id));
}

}  // namespace

extern "C" {

static bool import_and_init() {
  PyObject *module = PyImport_ImportModule("libzl_tpu.capi.bridge");
  if (module == nullptr) {
    report_python_error("initJuce/import");
    return false;
  }
  PyObject *r = PyObject_CallMethod(module, "init_engine", nullptr);
  if (r == nullptr) {
    Py_DECREF(module);
    report_python_error("initJuce/init_engine");
    return false;
  }
  Py_DECREF(r);
  g_bridge = module;
  return true;
}

void initJuce(void) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_initialized.load()) return;
  if (!Py_IsInitialized()) {
    // true embedding: we own the interpreter (and hold the GIL after init)
    Py_InitializeEx(0);
    if (!import_and_init()) {
      // release the GIL even on failure: leaving it held deadlocks every
      // later PyGILState_Ensure (retry of initJuce, any ABI call)
      g_main_state = PyEval_SaveThread();
      return;
    }
    g_initialized.store(true);
    // release the GIL so bridge pump threads and client threads can run
    g_main_state = PyEval_SaveThread();
  } else {
    // loaded into an existing interpreter (e.g. a ctypes client, the
    // reference's playtest pattern): take the GIL for the setup only
    Gil gil;
    if (!import_and_init()) return;
    g_initialized.store(true);
  }
}

void shutdownJuce(void) {
  if (!g_initialized.load()) return;
  {
    Gil gil;
    PyObject *r = PyObject_CallMethod(g_bridge, "shutdown_engine", nullptr);
    Py_XDECREF(r);
  }
  g_initialized.store(false);
}

void reloadZynthianConfiguration(void) {
  discard(call("reload_zynthian_configuration", ""));
}

void registerGraphicTypes(void) {
  // The reference registers QML item types (lib/libzl.cpp:421-423); this
  // build has no QML runtime — waveform data is served by
  // libzl_tpu.models.waveform instead. Intentionally a no-op.
}

float dBFromVolume(float vol) {
  return static_cast<float>(as_double(call("db_from_volume", "(f)", vol)));
}

void stopClips(int size, ClipAudioSource **clips) {
  if (!g_initialized.load()) {
    std::fprintf(stderr, "libzl: stopClips called before initJuce()\n");
    return;
  }
  Gil gil;
  PyObject *ids = PyList_New(size);
  if (ids == nullptr) {  // allocation failure must not crash the host
    report_python_error("stopClips");
    return;
  }
  for (int i = 0; i < size; ++i) {
    PyObject *v = PyLong_FromLong(clip_id(clips[i]));
    if (v == nullptr) {  // a NULL element would crash the bridge iteration
      report_python_error("stopClips");
      Py_DECREF(ids);
      return;
    }
    PyList_SetItem(ids, i, v);
  }
  PyObject *fn = PyObject_GetAttrString(g_bridge, "stop_clips");
  if (fn != nullptr) {
    PyObject *r = PyObject_CallFunctionObjArgs(fn, ids, nullptr);
    if (r == nullptr) report_python_error("stopClips");
    Py_XDECREF(r);
    Py_DECREF(fn);
  }
  Py_DECREF(ids);
}

/* ---- ClipAudioSource ---- */

ClipAudioSource *ClipAudioSource_new(const char *filepath, bool muted) {
  long id = as_long(call("clip_new", "(si)", filepath, muted ? 1 : 0), 0);
  return clip_handle(id);
}

ClipAudioSource *ClipAudioSource_byID(int id) {
  // ids are the handles; validate against the registry
  PyObject *r = call("clip_by_id", "(i)", id);
  bool ok = r != nullptr && r != Py_None;
  if (r != nullptr) {
    Gil gil;
    Py_DECREF(r);
  }
  return ok ? clip_handle(id) : nullptr;
}

int ClipAudioSource_id(ClipAudioSource *c) { return clip_id(c); }

void ClipAudioSource_destroy(ClipAudioSource *c) {
  discard(call("clip_destroy", "(i)", clip_id(c)));
}

void ClipAudioSource_play(ClipAudioSource *c, bool loop) {
  discard(call("clip_play", "(iii)", clip_id(c), loop ? 1 : 0, -2));
}

void ClipAudioSource_stop(ClipAudioSource *c) {
  discard(call("clip_stop", "(ii)", clip_id(c), -2));
}

void ClipAudioSource_playOnChannel(ClipAudioSource *c, bool loop,
                                   int midiChannel) {
  discard(call("clip_play", "(iii)", clip_id(c), loop ? 1 : 0, midiChannel));
}

void ClipAudioSource_stopOnChannel(ClipAudioSource *c, int midiChannel) {
  discard(call("clip_stop", "(ii)", clip_id(c), midiChannel));
}

float ClipAudioSource_getDuration(ClipAudioSource *c) {
  return static_cast<float>(as_double(call("clip_get_duration", "(i)",
                                           clip_id(c))));
}

const char *ClipAudioSource_getFileName(ClipAudioSource *c) {
  PyObject *r = call("clip_get_filename", "(i)", clip_id(c));
  if (r == nullptr) return "";
  Gil gil;
  const char *s = PyUnicode_AsUTF8(r);
  if (s == nullptr) {
    // non-UTF-8 filesystem name (surrogateescape): the conversion raised —
    // clear it, or every later PyErr_Occurred() check in as_double/as_long
    // silently returns its fallback and CPython runs with a pending
    // exception (forbidden)
    PyErr_Clear();
  }
  g_filename_storage = s ? s : "";
  Py_DECREF(r);
  return g_filename_storage.c_str();
}

void ClipAudioSource_setProgressCallback(ClipAudioSource *c,
                                         void (*functionPtr)(float)) {
  discard(call("clip_set_progress_callback", "(iL)", clip_id(c),
                  (long long)(intptr_t)functionPtr));
}

void ClipAudioSource_connectProgress(ClipAudioSource *, void *) {
  // Qt-signal plumbing in the reference; covered by setProgressCallback here.
}

void ClipAudioSource_setAudioLevelChangedCallback(ClipAudioSource *c,
                                                  void (*functionPtr)(float)) {
  discard(call("clip_set_audio_level_callback", "(iL)", clip_id(c),
                  (long long)(intptr_t)functionPtr));
}

void ClipAudioSource_setStartPosition(ClipAudioSource *c, float seconds) {
  discard(call("clip_set_start_position", "(if)", clip_id(c), seconds));
}

void ClipAudioSource_setLength(ClipAudioSource *c, float beat, int bpm) {
  discard(call("clip_set_length", "(ifi)", clip_id(c), beat, bpm));
}

void ClipAudioSource_setPan(ClipAudioSource *c, float pan) {
  discard(call("clip_set_pan", "(if)", clip_id(c), pan));
}

void ClipAudioSource_setSpeedRatio(ClipAudioSource *c, float ratio) {
  discard(call("clip_set_speed_ratio", "(if)", clip_id(c), ratio));
}

void ClipAudioSource_setPitch(ClipAudioSource *c, float pitch) {
  discard(call("clip_set_pitch", "(if)", clip_id(c), pitch));
}

void ClipAudioSource_setGain(ClipAudioSource *c, float db) {
  discard(call("clip_set_gain", "(if)", clip_id(c), db));
}

void ClipAudioSource_setVolume(ClipAudioSource *c, float vol) {
  discard(call("clip_set_volume", "(if)", clip_id(c), vol));
}

void ClipAudioSource_setSlices(ClipAudioSource *c, int slices) {
  discard(call("clip_set_slices", "(ii)", clip_id(c), slices));
}

void ClipAudioSource_setLoopCrossfade(ClipAudioSource *c, float seconds) {
  discard(call("clip_set_loop_crossfade", "(if)", clip_id(c), seconds));
}

int ClipAudioSource_keyZoneStart(ClipAudioSource *c) {
  return static_cast<int>(as_long(call("clip_keyzone_start", "(i)",
                                       clip_id(c))));
}

void ClipAudioSource_setKeyZoneStart(ClipAudioSource *c, int v) {
  discard(call("clip_set_keyzone_start", "(ii)", clip_id(c), v));
}

int ClipAudioSource_keyZoneEnd(ClipAudioSource *c) {
  return static_cast<int>(as_long(call("clip_keyzone_end", "(i)",
                                       clip_id(c)), 127));
}

void ClipAudioSource_setKeyZoneEnd(ClipAudioSource *c, int v) {
  discard(call("clip_set_keyzone_end", "(ii)", clip_id(c), v));
}

int ClipAudioSource_rootNote(ClipAudioSource *c) {
  return static_cast<int>(as_long(call("clip_root_note", "(i)", clip_id(c)),
                                  60));
}

void ClipAudioSource_setRootNote(ClipAudioSource *c, int v) {
  discard(call("clip_set_root_note", "(ii)", clip_id(c), v));
}

float ClipAudioSource_adsrAttack(ClipAudioSource *c) {
  return static_cast<float>(as_double(call("clip_adsr_attack", "(i)",
                                           clip_id(c))));
}

void ClipAudioSource_setADSRAttack(ClipAudioSource *c, float v) {
  discard(call("clip_set_adsr_attack", "(if)", clip_id(c), v));
}

float ClipAudioSource_adsrDecay(ClipAudioSource *c) {
  return static_cast<float>(as_double(call("clip_adsr_decay", "(i)",
                                           clip_id(c))));
}

void ClipAudioSource_setADSRDecay(ClipAudioSource *c, float v) {
  discard(call("clip_set_adsr_decay", "(if)", clip_id(c), v));
}

float ClipAudioSource_adsrSustain(ClipAudioSource *c) {
  return static_cast<float>(as_double(call("clip_adsr_sustain", "(i)",
                                           clip_id(c))));
}

void ClipAudioSource_setADSRSustain(ClipAudioSource *c, float v) {
  discard(call("clip_set_adsr_sustain", "(if)", clip_id(c), v));
}

float ClipAudioSource_adsrRelease(ClipAudioSource *c) {
  return static_cast<float>(as_double(call("clip_adsr_release", "(i)",
                                           clip_id(c))));
}

void ClipAudioSource_setADSRRelease(ClipAudioSource *c, float v) {
  discard(call("clip_set_adsr_release", "(if)", clip_id(c), v));
}

/* ---- SyncTimer ---- */

void *SyncTimer_instance(void) {
  // Opaque marker: the timer is a singleton inside the engine runtime.
  return g_initialized.load() ? (void *)&g_bridge : nullptr;
}

void SyncTimer_startTimer(int interval) {
  discard(call("timer_start", "(i)", interval));
}

void SyncTimer_stopTimer(void) { discard(call("timer_stop", "")); }

void SyncTimer_setBpm(unsigned int bpm) {
  discard(call("timer_set_bpm", "(I)", bpm));
}

int SyncTimer_getMultiplier(void) {
  return static_cast<int>(as_long(call("timer_get_multiplier", ""), 96));
}

void SyncTimer_registerTimerCallback(void (*functionPtr)(int)) {
  discard(call("timer_register_callback", "(L)",
                  (long long)(intptr_t)functionPtr));
}

void SyncTimer_deregisterTimerCallback(void (*functionPtr)(int)) {
  discard(call("timer_deregister_callback", "(L)",
                  (long long)(intptr_t)functionPtr));
}

void SyncTimer_queueClipToStart(ClipAudioSource *clip) {
  discard(call("timer_queue_clip_to_start", "(ii)", clip_id(clip), -1));
}

void SyncTimer_queueClipToStartOnChannel(ClipAudioSource *clip,
                                         int midiChannel) {
  discard(call("timer_queue_clip_to_start", "(ii)", clip_id(clip),
                  midiChannel));
}

void SyncTimer_queueClipToStop(ClipAudioSource *clip) {
  discard(call("timer_queue_clip_to_stop", "(ii)", clip_id(clip), -1));
}

void SyncTimer_queueClipToStopOnChannel(ClipAudioSource *clip,
                                        int midiChannel) {
  discard(call("timer_queue_clip_to_stop", "(ii)", clip_id(clip),
                  midiChannel));
}

/* ---- AudioLevels ---- */

bool AudioLevels_isRecording(void) {
  return as_long(call("levels_is_recording", "")) != 0;
}

void AudioLevels_setRecordGlobalPlayback(bool shouldRecord) {
  discard(call("levels_set_record_global_playback", "(i)",
                  shouldRecord ? 1 : 0));
}

void AudioLevels_setGlobalPlaybackFilenamePrefix(const char *prefix) {
  discard(call("levels_set_global_playback_filename_prefix", "(s)",
                  prefix));
}

void AudioLevels_startRecording(void) {
  discard(call("levels_start_recording", ""));
}

void AudioLevels_stopRecording(void) {
  discard(call("levels_stop_recording", ""));
}

void AudioLevels_setRecordPortsFilenamePrefix(const char *prefix) {
  discard(call("levels_set_record_ports_filename_prefix", "(s)", prefix));
}

void AudioLevels_addRecordPort(const char *portName, int channel) {
  discard(call("levels_add_record_port", "(si)", portName, channel));
}

void AudioLevels_removeRecordPort(const char *portName, int channel) {
  discard(call("levels_remove_record_port", "(si)", portName, channel));
}

void AudioLevels_clearRecordPorts(void) {
  discard(call("levels_clear_record_ports", ""));
}

void AudioLevels_setShouldRecordPorts(bool shouldRecord) {
  discard(call("levels_set_should_record_ports", "(i)",
                  shouldRecord ? 1 : 0));
}

/* ---- JackPassthrough ---- */

static void set_strip(int channel, const char *key, float value) {
  discard(call("passthrough_set", "(isf)", channel, key, value));
}

static float get_strip(int channel, const char *key) {
  return static_cast<float>(as_double(call("passthrough_get", "(is)",
                                           channel, key)));
}

void JackPassthrough_setPanAmount(int channel, float amount) {
  set_strip(channel, "pan", amount);
}
float JackPassthrough_getPanAmount(int channel) {
  return get_strip(channel, "pan");
}
float JackPassthrough_getWetFx1Amount(int channel) {
  return get_strip(channel, "wet1");
}
void JackPassthrough_setWetFx1Amount(int channel, float amount) {
  set_strip(channel, "wet1", amount);
}
float JackPassthrough_getWetFx2Amount(int channel) {
  return get_strip(channel, "wet2");
}
void JackPassthrough_setWetFx2Amount(int channel, float amount) {
  set_strip(channel, "wet2", amount);
}
float JackPassthrough_getDryAmount(int channel) {
  return get_strip(channel, "dry");
}
void JackPassthrough_setDryAmount(int channel, float amount) {
  set_strip(channel, "dry", amount);
}
float JackPassthrough_getMuted(int channel) {
  return get_strip(channel, "muted");
}
void JackPassthrough_setMuted(int channel, bool muted) {
  set_strip(channel, "muted", muted ? 1.0f : 0.0f);
}

}  // extern "C"
