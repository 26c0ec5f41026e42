// Engine implementation. See include/engine.h for the design.
//
// Concurrency model: one mutex, as in the reference engine. On a GPU the
// hook records every GEMM, collective and copy — about 340 GEMMs a train
// step of the 8-layer model — so each record stays a short critical
// section (a window slot, a ring slot, a name lookup) and the trace ring
// has a fixed capacity (TPU_TIMER_TRACE_CAP events, default 65536).

#include "engine.h"

#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdio>
#include <fstream>
#include <sstream>
#include <thread>

namespace tpu_timer {

int64_t NowUs() {
  struct timeval tv;
  gettimeofday(&tv, nullptr);
  return int64_t(tv.tv_sec) * 1000000 + tv.tv_usec;
}

void KernelStats::add(double dur_us, double payload) {
  if (window.empty()) window.resize(kWindow, 0.0);
  window[next] = dur_us;
  next = (next + 1) % kWindow;
  if (next == 0) full = true;
  count++;
  total_us += dur_us;
  total_payload += payload;
  if (dur_us > 0 && payload > 0) payload_rate = payload / (dur_us * 1e-6);
}

void KernelStats::summarize(double* avg, double* mx, double* p99,
                            double* mn) const {
  int n = full ? kWindow : next;
  if (n == 0) {
    *avg = *mx = *p99 = *mn = 0;
    return;
  }
  std::vector<double> sorted(window.begin(), window.begin() + n);
  std::sort(sorted.begin(), sorted.end());
  double sum = 0;
  for (double d : sorted) sum += d;
  *avg = sum / n;
  *mn = sorted.front();
  *mx = sorted.back();
  *p99 = sorted[std::min(n - 1, (int)(0.99 * n))];
}

namespace {
// op_telemetry.BUCKET_BOUNDS_US
const double kOpBucketBounds[OpClassHist::kBuckets - 1] = {
    10, 40, 160, 640, 2560, 10240, 40960, 163840, 655360, 2621440, 10485760};
const char* kOpClassNames[4] = {"compute", "collective", "input", "ckpt"};

bool Contains(const std::string& low, const char* marker) {
  return low.find(marker) != std::string::npos;
}

// op_telemetry.classify: a collective kind is collective; otherwise the
// name's checkpoint markers, then its input markers, else compute. The
// GC hook's pauses (py_gc) and copies get no class.
int Classify(int kind, const std::string& name) {
  if (kind == kColl) return kOpCollective;
  if (kind != kMatmul || name == "py_gc") return kOpNone;
  std::string low(name);
  for (char& c : low) c = (char)tolower((unsigned char)c);
  for (const char* m : {"ckpt", "checkpoint", "save", "restore"})
    if (Contains(low, m)) return kOpCkpt;
  for (const char* m :
       {"input", "data_load", "dataload", "next_batch", "host_fetch"})
    if (Contains(low, m)) return kOpInput;
  return kOpCompute;
}

void JsonString(std::ostringstream& out, const std::string& s) {
  out << '"';
  for (char c : s) {
    if (c == '"' || c == '\\') {
      out << '\\' << c;
    } else if ((unsigned char)c < 0x20) {
      char buf[8];
      snprintf(buf, sizeof(buf), "\\u%04x", (unsigned char)c);
      out << buf;
    } else {
      out << c;
    }
  }
  out << '"';
}
}  // namespace

void OpClassHist::observe(double dur_us) {
  if (!(dur_us > 0)) dur_us = 0;
  int idx = kBuckets - 1;
  for (int i = 0; i < kBuckets - 1; i++) {
    if (dur_us <= kOpBucketBounds[i]) {
      idx = i;
      break;
    }
  }
  b[idx]++;
  sum_us += dur_us;
  if (dur_us > max_us) max_us = dur_us;
  n++;
}

Engine& Engine::instance() {
  static Engine* e = new Engine();
  return *e;
}

void Engine::init(int rank, int world_size, int local_rank, int port) {
  bool expected = false;
  if (!started_.compare_exchange_strong(expected, true)) return;
  rank_ = rank;
  world_size_ = world_size;
  local_rank_ = local_rank;
  port_ = port;
  if (const char* cap = getenv("TPU_TIMER_TRACE_CAP"))
    trace_cap_ = std::max(1024L, atol(cap));
  if (const char* t = getenv("TPU_TIMER_HANG_TIMEOUT"))
    hang_timeout_s_ = atof(t);
  stopped_.store(false);
  setGauge("HANG", 0);  // present from the first scrape, not the first tick
  std::thread(&Engine::watchdogLoop, this).detach();
  if (port_ > 0) std::thread(&Engine::httpLoop, this).detach();
}

void Engine::shutdown() {
  stopped_.store(true);
  if (server_fd_ >= 0) {
    ::shutdown(server_fd_, SHUT_RDWR);
    close(server_fd_);
    server_fd_ = -1;
  }
  started_.store(false);
}

int32_t Engine::internName(const std::string& name) {
  auto it = name_ids_.find(name);
  if (it != name_ids_.end()) return it->second;
  int32_t id = (int32_t)names_.size();
  names_.push_back(name);
  name_ids_[name] = id;
  return id;
}

void Engine::recordLocked(int kind, int op_class, const std::string& name,
                          double dur_us, double payload, int64_t m, int64_t n,
                          int64_t k, int32_t batch) {
  stats_[kind][name].add(dur_us, payload);
  if (op_class != kOpNone) {
    op_hists_[op_class].observe(dur_us);
    op_seq_++;
  }
  if (trace_.empty()) trace_.resize(trace_cap_);
  TraceEvent& ev = trace_[trace_next_];
  ev.ts_us = NowUs() - (int64_t)dur_us;
  ev.dur_us = (int64_t)dur_us;
  ev.payload = payload;
  ev.m = m;
  ev.n = n;
  ev.k = k;
  ev.batch = batch;
  ev.name_id = internName(name);
  ev.kind = (int8_t)kind;
  trace_next_ = (trace_next_ + 1) % trace_cap_;
  if (trace_next_ == 0) trace_full_ = true;
}

void Engine::record(int kind, const std::string& name, double dur_us,
                    double payload) {
  if (kind < 0 || kind > 2) return;
  std::lock_guard<std::mutex> g(mu_);
  recordLocked(kind, Classify(kind, name), name, dur_us, payload, 0, 0, 0, 0);
}

void Engine::recordGemm(const std::string& name, double dur_us, double flops,
                        int64_t m, int64_t n, int64_t k, int32_t batch) {
  std::lock_guard<std::mutex> g(mu_);
  recordLocked(kMatmul, kOpCompute, name, dur_us, flops, m, n, k, batch);
}

void Engine::enterCollective(const std::string& name) {
  std::lock_guard<std::mutex> g(mu_);
  coll_seq_++;
  last_coll_ = name;
  op_seq_++;
}

std::string Engine::opTelemetryJson() {
  std::ostringstream out;
  out.precision(17);
  std::lock_guard<std::mutex> g(mu_);
  out << "{\"seq\":" << op_seq_ << ",\"classes\":{";
  bool first = true;
  for (int c = 0; c < 4; c++) {
    const OpClassHist& h = op_hists_[c];
    if (!h.n) continue;
    if (!first) out << ",";
    first = false;
    out << "\"" << kOpClassNames[c] << "\":{\"b\":[";
    for (int i = 0; i < OpClassHist::kBuckets; i++)
      out << (i ? "," : "") << h.b[i];
    out << "],\"sum\":" << h.sum_us << ",\"max\":" << h.max_us
        << ",\"n\":" << h.n << "}";
  }
  out << "},\"last_collective\":{\"name\":";
  JsonString(out, last_coll_);
  out << ",\"seq\":" << coll_seq_ << "}}";
  return out.str();
}

uint64_t Engine::begin(int kind, const std::string& name) {
  uint64_t token = next_token_.fetch_add(1);
  if (kind == kColl) enterCollective(name);
  std::lock_guard<std::mutex> g(mu_);
  inflight_[token] = InflightOp{name, kind, NowUs()};
  return token;
}

void Engine::end(uint64_t token, double payload) {
  InflightOp op;
  {
    std::lock_guard<std::mutex> g(mu_);
    auto it = inflight_.find(token);
    if (it == inflight_.end()) return;
    op = it->second;
    inflight_.erase(it);
  }
  double dur_us = (double)(NowUs() - op.start_us);
  record(op.kind, op.name, dur_us, payload);
}

void Engine::setGauge(const std::string& name, double v) {
  std::lock_guard<std::mutex> g(mu_);
  gauges_[name] = v;
}

void Engine::incCounter(const std::string& name, double v) {
  std::lock_guard<std::mutex> g(mu_);
  counters_[name] += v;
}

void Engine::setDeviceStuck(const std::string& what, int64_t since_us) {
  std::lock_guard<std::mutex> g(mu_);
  device_stuck_ = what;
  device_stuck_since_us_ = since_us;
}

void Engine::watchdogLoop() {
  // Reference behavior (manager.cc doHang:389–414): on a stuck operator,
  // push HANG/START_DUMP gauges, dump stacks once, END_DUMP with the dump
  // latency, optionally exit if TPU_TIMER_HANG_KILL.
  bool dumped = false;
  while (!stopped_.load()) {
    std::this_thread::sleep_for(std::chrono::milliseconds(200));
    std::string stuck_name, device_what;
    double stuck_s = 0;
    {
      std::lock_guard<std::mutex> g(mu_);
      int64_t now = NowUs();
      for (auto& kv : inflight_) {
        double s = (now - kv.second.start_us) * 1e-6;
        if (s > hang_timeout_s_ && s > stuck_s) {
          stuck_s = s;
          stuck_name = kv.second.name;
        }
      }
      if (!device_stuck_.empty()) {
        double s = (now - device_stuck_since_us_) * 1e-6;
        if (s > hang_timeout_s_ && s > stuck_s) {
          stuck_s = s;
          stuck_name = device_stuck_;
          device_what = device_stuck_;
        }
      }
    }
    if (stuck_name.empty()) {
      hang_detected_.store(false);
      setGauge("HANG", 0);
      continue;
    }
    hang_detected_.store(true);
    setGauge("HANG", 1);
    if (!dumped) {
      dumped = true;
      setGauge("START_DUMP", 1);
      int64_t t0 = NowUs();
      char path[256];
      snprintf(path, sizeof(path), "/tmp/tpu_timer_hang_%d.txt", getpid());
      std::ofstream f(path);
      if (device_what.empty()) {
        f << "rank " << rank_ << " hang: op '" << stuck_name
          << "' in flight " << stuck_s << "s (timeout " << hang_timeout_s_
          << "s)\n";
      } else {
        f << "rank " << rank_ << " hang: device op " << device_what
          << " incomplete, no completed event on its stream for " << stuck_s
          << "s (timeout " << hang_timeout_s_ << "s)\n";
      }
      f.close();
      if (hang_cb_) hang_cb_(stuck_name.c_str(), stuck_s);
      // the launcher registers faulthandler on this signal, so raising it
      // writes all Python thread stacks — the py-spy analogue
      if (hang_signal_ > 0) raise(hang_signal_);
      setGauge("END_DUMP", (NowUs() - t0) * 1e-6);
      if (getenv("TPU_TIMER_HANG_KILL")) _exit(17);
    }
  }
}

namespace {
struct Family {
  const char* prefix;
  const char* payload_name;  // FLOPS / BANDWIDTH / null
  int kind;
};
const Family kFamilies[] = {
    {"XPU_TIMER_MM_KERNEL_", "FLOPS", kMatmul},
    {"XPU_TIMER_COLL_KERNEL_", "BANDWIDTH", kColl},
};
}  // namespace

std::string Engine::prometheusText() {
  std::ostringstream out;
  std::lock_guard<std::mutex> g(mu_);
  char labels[256];
  for (const Family& fam : kFamilies) {
    for (auto& kv : stats_[fam.kind]) {
      double avg, mx, p99, mn;
      kv.second.summarize(&avg, &mx, &p99, &mn);
      snprintf(labels, sizeof(labels), "{kernel=\"%s\",rank=\"%d\"}",
               kv.first.c_str(), rank_);
      out << fam.prefix << "AVG_LATENCY" << labels << " " << avg << "\n";
      out << fam.prefix << "MAX_LATENCY" << labels << " " << mx << "\n";
      out << fam.prefix << "P99_LATENCY" << labels << " " << p99 << "\n";
      out << fam.prefix << "MIN_LATENCY" << labels << " " << mn << "\n";
      out << fam.prefix << fam.payload_name << labels << " "
          << kv.second.payload_rate << "\n";
      out << fam.prefix << "COUNT" << labels << " " << kv.second.count << "\n";
    }
  }
  for (auto& kv : stats_[kMemory]) {
    snprintf(labels, sizeof(labels), "{kernel=\"%s\",rank=\"%d\"}",
             kv.first.c_str(), rank_);
    out << "XPU_TIMER_MEMORY_COUNTER" << labels << " " << kv.second.count
        << "\n";
    out << "XPU_TIMER_MEMORY_BYTES" << labels << " "
        << kv.second.total_payload << "\n";
  }
  snprintf(labels, sizeof(labels), "{rank=\"%d\"}", rank_);
  for (auto& kv : gauges_)
    out << "XPU_TIMER_COMMON_" << kv.first << labels << " " << kv.second
        << "\n";
  for (auto& kv : counters_)
    out << "XPU_TIMER_COMMON_" << kv.first << labels << " " << kv.second
        << "\n";
  out << "XPU_TIMER_COMMON_PID" << labels << " " << getpid() << "\n";
  return out.str();
}

std::string Engine::traceJson() {
  std::ostringstream out;
  // payloads in full: a GiB copy's bytes read back exactly
  out.precision(17);
  std::lock_guard<std::mutex> g(mu_);
  static const char* kKindName[] = {"mm", "coll", "memory"};
  // kind-appropriate payload key: mm events carry FLOPs, memory events
  // bytes, anything else is opaque payload
  static const char* kPayloadKey[] = {"flops", "payload", "bytes"};
  out << "{\"traceEvents\":[";
  size_t n = trace_full_ ? trace_cap_ : trace_next_;
  bool first = true;
  for (size_t i = 0; i < n; i++) {
    const TraceEvent& ev = trace_[i];
    if (!first) out << ",";
    first = false;
    // a NaN/inf payload must not poison the whole trace JSON (json
    // parsers reject bare nan/inf)
    double payload = std::isfinite(ev.payload) ? ev.payload : 0.0;
    out << "{\"name\":\"" << names_[ev.name_id] << "\",\"cat\":\""
        << kKindName[(int)ev.kind] << "\",\"ph\":\"X\",\"ts\":" << ev.ts_us
        << ",\"dur\":" << ev.dur_us << ",\"pid\":" << rank_
        << ",\"tid\":" << (int)ev.kind
        << ",\"args\":{\"" << kPayloadKey[(int)ev.kind] << "\":"
        << payload;
    // the shape the hook captured, for an exact-shape replay
    if (ev.m > 0)
      out << ",\"m\":" << ev.m << ",\"n\":" << ev.n << ",\"k\":" << ev.k
          << ",\"batch\":" << ev.batch;
    out << "}}";
  }
  out << "]}";
  return out.str();
}

bool Engine::dumpTrace(const std::string& path) {
  std::ofstream f(path);
  if (!f.good()) return false;
  f << traceJson();
  return f.good();
}

// ---------------------------------------------------------------------------
// Minimal HTTP/1.0 server: GET /metrics (Prometheus text), /trace (chrome
// trace JSON), /healthz — the reference engine's routes, byte for byte.
// ---------------------------------------------------------------------------
void Engine::httpLoop() {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port_);
  if (bind(fd, (struct sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(fd, 16) != 0) {
    close(fd);
    return;
  }
  server_fd_ = fd;
  while (!stopped_.load()) {
    int cfd = accept(fd, nullptr, nullptr);
    if (cfd < 0) {
      if (stopped_.load()) break;
      continue;
    }
    char req[1024];
    ssize_t n = read(cfd, req, sizeof(req) - 1);
    std::string body, ctype = "text/plain";
    int status = 200;
    if (n > 0) {
      req[n] = 0;
      if (strncmp(req, "GET /metrics", 12) == 0) {
        body = prometheusText();
      } else if (strncmp(req, "GET /trace", 10) == 0) {
        body = traceJson();
        ctype = "application/json";
      } else if (strncmp(req, "GET /healthz", 12) == 0) {
        char buf[128];
        snprintf(buf, sizeof(buf),
                 "{\"pid\":%d,\"rank\":%d,\"world_size\":%d,\"hang\":%d}",
                 getpid(), rank_, world_size_, hang_detected_.load() ? 1 : 0);
        body = buf;
        ctype = "application/json";
      } else {
        status = 404;
        body = "not found\n";
      }
    }
    char hdr[256];
    snprintf(hdr, sizeof(hdr),
             "HTTP/1.0 %d %s\r\nContent-Type: %s\r\nContent-Length: "
             "%zu\r\nConnection: close\r\n\r\n",
             status, status == 200 ? "OK" : "Not Found", ctype.c_str(),
             body.size());
    (void)!write(cfd, hdr, strlen(hdr));
    (void)!write(cfd, body.data(), body.size());
    close(cfd);
  }
}

}  // namespace tpu_timer
