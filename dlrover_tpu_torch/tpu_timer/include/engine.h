// tpu_timer engine for the PyTorch/CUDA port: per-kernel device timing,
// gauges, a chrome-trace ring, an HTTP endpoint and a hang watchdog.
//
// The port's copy of the reference engine (tpu_timer/include/tpu_timer/
// engine.h). The reference times PJRT module dispatch on a TPU; on a GPU
// the port goes back to upstream xpu_timer's design: an LD_PRELOAD library
// (src/cuda_hook.cc) interposes cuBLAS, cuBLASLt, NCCL and cudart calls
// and times each with a pair of CUDA events on the caller's stream. The
// hook feeds this engine, which keeps the reference's metric families,
// trace format, HTTP routes, env keys and hang file, so a JAX agent's
// collector scrapes a port worker and the reverse:
//   XPU_TIMER_MM_KERNEL_{AVG,MAX,P99,MIN}_LATENCY / _FLOPS / _COUNT
//   XPU_TIMER_COLL_KERNEL_{AVG,MAX,P99,MIN}_LATENCY / _BANDWIDTH / _COUNT
//   XPU_TIMER_MEMORY_COUNTER / _BYTES
//   XPU_TIMER_COMMON_{HANG,START_DUMP,END_DUMP,GC_COUNT,...,PID}
//
// Beside them the engine keeps the op-class telemetry of
// dlrover_tpu_torch/observability/op_telemetry.py over everything it
// records: four fixed-bucket histograms (compute, collective, input, ckpt)
// with that module's bucket bounds, the observation count, and the
// last-entered-collective marker, read as that module's wire JSON
// (opTelemetryJson). A hooked GEMM is compute, a hooked or Python
// collective is collective, a Python span is classed by its name as
// op_telemetry.classify does, and a hooked copy has no class.
//
// The watchdog judges two things stuck: a host bracket (begin without end)
// older than the timeout, as the reference does, and a device stream the
// hook reports through setDeviceStuck (an op whose end event is incomplete
// while its stream has shown no completed event for the timeout).
#pragma once

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace tpu_timer {

enum KernelKind : int {
  kMatmul = 0,  // cuBLAS / cuBLASLt GEMMs and host spans
  kColl = 1,    // NCCL collectives
  kMemory = 2,  // cudaMemcpyAsync
};

struct TraceEvent {
  int64_t ts_us;   // wall-clock start, us since epoch
  int64_t dur_us;  // duration
  double payload;  // FLOPs (mm) / bytes (coll, memory)
  int64_t m, n, k;  // GEMM dims the hook captured (0: not a hooked GEMM)
  int32_t batch;
  int32_t name_id;
  int8_t kind;
};

// Sliding-window stats over the last kWindow durations of one kernel name.
struct KernelStats {
  static constexpr int kWindow = 512;
  std::vector<double> window;  // ring of recent durations (us)
  int next = 0;
  bool full = false;
  uint64_t count = 0;
  double total_us = 0;
  double payload_rate = 0;  // FLOPS (mm) or bytes/s (coll), from last record
  double total_payload = 0;

  void add(double dur_us, double payload);
  // avg/max/p99/min over the window (us).
  void summarize(double* avg, double* mx, double* p99, double* mn) const;
};

// One op class's histogram: op_telemetry.OpClassHistogram.
struct OpClassHist {
  static constexpr int kBuckets = 12;  // 11 bounds + overflow
  uint64_t b[kBuckets] = {0};
  double sum_us = 0;
  double max_us = 0;
  uint64_t n = 0;
  void observe(double dur_us);
};

enum OpClassId : int {
  kOpNone = -1,
  kOpCompute = 0,
  kOpCollective = 1,
  kOpInput = 2,
  kOpCkpt = 3,
};

struct InflightOp {
  std::string name;
  int kind;
  int64_t start_us;
};

class Engine {
 public:
  static Engine& instance();

  // port > 0 starts the HTTP metrics server on that port; port == 0 disables.
  void init(int rank, int world_size, int local_rank, int port);
  void shutdown();

  void record(int kind, const std::string& name, double dur_us,
              double payload);
  // A hooked GEMM: the record plus the m, n, k and batch count it ran at.
  void recordGemm(const std::string& name, double dur_us, double flops,
                  int64_t m, int64_t n, int64_t k, int32_t batch);
  // Begin/end bracket feeding both stats and the hang watchdog.
  uint64_t begin(int kind, const std::string& name);
  void end(uint64_t token, double payload);

  // A collective was entered (a hooked NCCL call, or a Python collective
  // span's begin): marked before anything runs, so a rank parked inside
  // one shows it.
  void enterCollective(const std::string& name);
  // The cumulative op-class telemetry as op_telemetry.py's wire JSON.
  std::string opTelemetryJson();

  void setGauge(const std::string& name, double v);
  void incCounter(const std::string& name, double v);

  // The hook's verdict on the device: `what` names the stuck op and its
  // stream, `since_us` is when that stream last showed progress. An empty
  // `what` clears it.
  void setDeviceStuck(const std::string& what, int64_t since_us);

  void setHangTimeout(double seconds) { hang_timeout_s_ = seconds; }
  // Signal raised in-process on hang (0 = none). The Python side registers
  // a faulthandler on it, so the raise writes every Python thread's stack.
  void setHangSignal(int sig) { hang_signal_ = sig; }
  typedef void (*HangCallback)(const char* inflight_name, double stuck_s);
  void setHangCallback(HangCallback cb) { hang_cb_ = cb; }

  std::string prometheusText();
  std::string traceJson();  // chrome-trace "traceEvents" JSON
  bool dumpTrace(const std::string& path);

  int rank() const { return rank_; }
  int port() const { return port_; }
  bool hangDetected() const { return hang_detected_.load(); }

 private:
  Engine() = default;
  void watchdogLoop();
  void httpLoop();
  int32_t internName(const std::string& name);
  void recordLocked(int kind, int op_class, const std::string& name,
                    double dur_us, double payload, int64_t m, int64_t n,
                    int64_t k, int32_t batch);

  std::mutex mu_;
  std::unordered_map<std::string, KernelStats> stats_[3];
  std::map<std::string, double> gauges_;     // common gauges
  std::map<std::string, double> counters_;   // monotonic counters
  std::vector<TraceEvent> trace_;
  size_t trace_cap_ = 65536;
  size_t trace_next_ = 0;
  bool trace_full_ = false;
  std::vector<std::string> names_;
  std::unordered_map<std::string, int32_t> name_ids_;
  std::unordered_map<uint64_t, InflightOp> inflight_;
  std::atomic<uint64_t> next_token_{1};
  OpClassHist op_hists_[4];
  uint64_t op_seq_ = 0;
  uint64_t coll_seq_ = 0;
  std::string last_coll_;
  std::string device_stuck_;
  int64_t device_stuck_since_us_ = 0;

  int rank_ = 0;
  int world_size_ = 1;
  int local_rank_ = 0;
  int port_ = 0;
  int server_fd_ = -1;
  double hang_timeout_s_ = 300.0;
  int hang_signal_ = 0;
  HangCallback hang_cb_ = nullptr;
  std::atomic<bool> hang_detected_{false};
  std::atomic<bool> stopped_{false};
  std::atomic<bool> started_{false};
};

int64_t NowUs();

// The CUDA hook (src/cuda_hook.cc). Inert until hookStart; hookStart opens
// libcuda.so.1 and starts the poller, and returns false when the driver
// cannot be loaded.
bool hookStart();
void hookStop();
// Whether this library's interposers are the process's definitions of the
// hooked symbols (it was preloaded), not just a library loaded beside them.
bool hookInterposed();
void hookSetEnabled(bool on);
// Ops enqueued whose end event the poller has not yet seen complete.
int64_t hookPending();
// Seconds since the longest-stuck stream (an op's end event incomplete)
// last showed progress; 0 when every stream's head has completed.
double hookStuckSeconds();

}  // namespace tpu_timer
