// extern "C" surface for ctypes (dlrover_tpu_torch/observability/
// tpu_timer.py): the reference's tt_* entry points (tpu_timer/src/capi.cc),
// with tt_init also starting the CUDA hook, and the hook's own controls.

#include <string.h>

#include "engine.h"

using tpu_timer::Engine;

namespace {
int CopyOut(const std::string& s, char* buf, int cap) {
  if (buf && cap > 0) {
    int n = (int)s.size() < cap - 1 ? (int)s.size() : cap - 1;
    memcpy(buf, s.data(), n);
    buf[n] = 0;
  }
  return (int)s.size();
}
}  // namespace

// the library is built with hidden visibility: only these entry points and
// the hook's interposers are exported
#pragma GCC visibility push(default)
extern "C" {

// Starts the engine (watchdog, and the HTTP endpoint when port > 0) and the
// CUDA hook. Returns 0, or 1 when libcuda.so.1 could not be loaded: the
// engine then runs and the hook stays inert.
int tt_init(int rank, int world_size, int local_rank, int port) {
  Engine::instance().init(rank, world_size, local_rank, port);
  return tpu_timer::hookStart() ? 0 : 1;
}

void tt_shutdown() {
  tpu_timer::hookStop();
  Engine::instance().shutdown();
}

void tt_record(int kind, const char* name, double dur_us, double payload) {
  Engine::instance().record(kind, name ? name : "?", dur_us, payload);
}

unsigned long long tt_begin(int kind, const char* name) {
  return Engine::instance().begin(kind, name ? name : "?");
}

void tt_end(unsigned long long token, double payload) {
  Engine::instance().end(token, payload);
}

void tt_set_gauge(const char* name, double v) {
  Engine::instance().setGauge(name, v);
}

void tt_inc_counter(const char* name, double v) {
  Engine::instance().incCounter(name, v);
}

void tt_set_hang_timeout(double seconds) {
  Engine::instance().setHangTimeout(seconds);
}

void tt_set_hang_signal(int sig) { Engine::instance().setHangSignal(sig); }

void tt_set_hang_callback(void (*cb)(const char*, double)) {
  Engine::instance().setHangCallback(cb);
}

int tt_hang_detected() { return Engine::instance().hangDetected() ? 1 : 0; }

// Copies the Prometheus exposition text into buf; returns the full length
// (call with cap=0 to size the buffer).
int tt_prometheus(char* buf, int cap) {
  return CopyOut(Engine::instance().prometheusText(), buf, cap);
}

// The chrome-trace JSON of the ring, as tt_prometheus copies its text.
int tt_trace_json(char* buf, int cap) {
  return CopyOut(Engine::instance().traceJson(), buf, cap);
}

// The cumulative op-class telemetry (observability/op_telemetry.py's wire
// JSON), copied out as tt_prometheus copies its text.
int tt_op_telemetry(char* buf, int cap) {
  return CopyOut(Engine::instance().opTelemetryJson(), buf, cap);
}

int tt_dump_trace(const char* path) {
  return Engine::instance().dumpTrace(path) ? 0 : -1;
}

int tt_hook_interposed() { return tpu_timer::hookInterposed() ? 1 : 0; }

void tt_hook_set_enabled(int on) { tpu_timer::hookSetEnabled(on != 0); }

long long tt_hook_pending() { return tpu_timer::hookPending(); }

double tt_hook_stuck_seconds() { return tpu_timer::hookStuckSeconds(); }

}  // extern "C"
#pragma GCC visibility pop
