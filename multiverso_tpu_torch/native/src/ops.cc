#include "mvtpu/ops.h"

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <deque>
#include <sstream>
#include <vector>

#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/latency.h"
#include "mvtpu/log.h"
#include "mvtpu/mutex.h"
#include "mvtpu/profiler.h"
#include "mvtpu/qos.h"
#include "mvtpu/watchdog.h"
#include "mvtpu/zoo.h"

namespace mvtpu {
namespace ops {

namespace {

Mutex g_mu;
std::string g_host_metrics GUARDED_BY(g_mu);
// Host-pushed alert state (JSON object text from the Python health
// evaluator, spliced verbatim into the "alerts" report — the native
// side never parses it).  Empty = no host push yet.
std::string g_host_alerts GUARDED_BY(g_mu);

struct Event {
  int64_t ts_us;
  std::string kind;
  std::string detail;
};
Mutex g_box_mu;
// mvlint: MV018-exempt(bounded ring — BlackboxEvent pops the front
// past -blackbox_events; the ring IS the black box, never traffic)
std::deque<Event> g_events GUARDED_BY(g_box_mu);
long long g_triggers GUARDED_BY(g_box_mu) = 0;

int64_t NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

// Minimal JSON string escape (names/details are runtime-controlled, but
// a rogue flag value must not produce an unparseable black box).
std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c & 0xff);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

std::vector<std::string> SplitTabs(const std::string& line) {
  std::vector<std::string> out;
  size_t start = 0;
  while (true) {
    size_t tab = line.find('\t', start);
    if (tab == std::string::npos) {
      out.push_back(line.substr(start));
      return out;
    }
    out.push_back(line.substr(start, tab - start));
    start = tab + 1;
  }
}

std::vector<long long> SplitCsv(const std::string& s) {
  std::vector<long long> out;
  size_t start = 0;
  while (start <= s.size()) {
    size_t comma = s.find(',', start);
    std::string tok = s.substr(
        start, comma == std::string::npos ? std::string::npos
                                          : comma - start);
    if (!tok.empty()) out.push_back(std::stoll(tok));
    if (comma == std::string::npos) break;
    start = comma + 1;
  }
  return out;
}

std::string FmtDouble(double v) {
  char buf[64];
  std::snprintf(buf, sizeof(buf), "%.9g", v);
  return buf;
}

// Native Dashboard -> Prometheus exposition, with per-bucket exemplar
// trace ids in OpenMetrics style:
//   name_bucket{le="0.001024"} 17 # {trace_id="0x..."} 0.001024
// Served only when the host has not pushed its own (superset)
// rendering — the pushed text already bridges every native monitor.
std::string RenderNativePrometheus() {
  std::ostringstream os;
  std::istringstream in(Dashboard::Dump());
  std::string line;
  while (std::getline(in, line)) {
    if (line.empty()) continue;
    auto fields = SplitTabs(line);
    if (fields.size() < 5) continue;
    const std::string pname = PromName(fields[0]);
    long long count = std::stoll(fields[1]);
    double total = std::stod(fields[2]);
    auto buckets = SplitCsv(fields[4]);
    std::vector<long long> exemplars;
    if (fields.size() >= 6) exemplars = SplitCsv(fields[5]);
    os << "# TYPE " << pname << " histogram\n";
    long long cum = 0;
    double bound = 1e-6;
    for (size_t i = 0; i < buckets.size(); ++i) {
      bool inf = i + 1 == buckets.size();
      cum += buckets[i];
      os << pname << "_bucket{le=\""
         << (inf ? "+Inf" : FmtDouble(bound)) << "\"} " << cum;
      if (i < exemplars.size() && exemplars[i] != 0) {
        char hex[32];
        std::snprintf(hex, sizeof(hex), "0x%llx",
                      static_cast<unsigned long long>(exemplars[i]));
        os << " # {trace_id=\"" << hex << "\"} "
           << (inf ? FmtDouble(bound) : FmtDouble(bound));
      }
      os << '\n';
      bound *= 2.0;
    }
    os << pname << "_sum " << FmtDouble(total) << '\n';
    os << pname << "_count " << count << '\n';
  }
  return os.str();
}

// Interpolated q-quantile out of the Dashboard's fixed log2 buckets
// (bucket i holds values <= 1e-6 * 2^i seconds; the last is +inf) —
// the native mirror of metrics.py Histogram.quantile, so latdoctor and
// a Python scrape agree to within one bucket ratio.
double BucketQuantile(const std::vector<long long>& buckets,
                      long long count, double vmax, double q) {
  if (count <= 0 || buckets.empty()) return 0.0;
  double target = q * static_cast<double>(count);
  long long cum = 0;
  double bound = 1e-6;
  for (size_t i = 0; i < buckets.size(); ++i) {
    long long c = buckets[i];
    if (c > 0 && static_cast<double>(cum + c) >= target) {
      double lo = i > 0 ? bound / 2.0 : 0.0;
      double hi = i + 1 < buckets.size() ? bound : vmax;
      double v = lo + (hi - lo) * (target - static_cast<double>(cum)) /
                          static_cast<double>(c);
      return std::min(v, vmax > 0 ? vmax : v);
    }
    cum += c;
    if (i + 1 < buckets.size()) bound *= 2.0;
  }
  return vmax;
}

// One stage's JSON object from a parsed MV_DumpMonitors line.
std::string StageJson(const std::vector<std::string>& fields) {
  long long count = std::stoll(fields[1]);
  double total = std::stod(fields[2]);
  double vmax = std::stod(fields[3]);
  auto buckets = SplitCsv(fields[4]);
  std::ostringstream os;
  os << "{\"count\":" << count << ",\"sum_s\":" << FmtDouble(total)
     << ",\"max_ms\":" << FmtDouble(vmax * 1e3);
  for (auto [name, q] : {std::pair<const char*, double>{"p50_ms", 0.50},
                         {"p95_ms", 0.95},
                         {"p99_ms", 0.99}})
    os << ",\"" << name << "\":"
       << FmtDouble(BucketQuantile(buckets, count, vmax, q) * 1e3);
  if (fields.size() >= 6) {
    // The p99 bucket's exemplar trace id (0 = none): the link from a
    // slow stage straight into the merged Chrome trace.
    auto exemplars = SplitCsv(fields[5]);
    double target = 0.99 * static_cast<double>(count);
    long long cum = 0;
    long long ex = 0;
    for (size_t i = 0; i < buckets.size() && i < exemplars.size(); ++i) {
      cum += buckets[i];
      if (buckets[i] > 0 && exemplars[i] != 0) ex = exemplars[i];
      if (static_cast<double>(cum) >= target && ex != 0) break;
    }
    if (ex != 0) {
      char hex[32];
      std::snprintf(hex, sizeof(hex), "0x%llx",
                    static_cast<unsigned long long>(ex));
      os << ",\"exemplar_p99\":\"" << hex << "\"";
    }
  }
  os << "}";
  return os.str();
}

// The "latency" OpsQuery kind (docs/observability.md "latency plane"):
// per-stage histograms (from the lat.stage.* Dashboard monitors the
// timing trail feeds), the end-to-end lat.total, per-peer clock
// offsets, and the sampling profiler's status — everything latdoctor
// needs to name the dominant stage per percentile.  Fleet scope comes
// free through the generic JSON merge.
std::string LatencyJson() {
  std::ostringstream os;
  os << "{\"rank\":" << Zoo::Get()->rank();
  os << ",\"armed\":" << (latency::Armed() ? "true" : "false");
  os << ",\"stages\":{";
  bool first = true;
  std::string total_json;
  std::istringstream in(Dashboard::Dump());
  std::string line;
  while (std::getline(in, line)) {
    if (line.empty()) continue;
    auto fields = SplitTabs(line);
    if (fields.size() < 5) continue;
    const std::string& name = fields[0];
    if (name == "lat.total") {
      total_json = StageJson(fields);
      continue;
    }
    constexpr const char kPrefix[] = "lat.stage.";
    if (name.rfind(kPrefix, 0) != 0) continue;
    if (!first) os << ',';
    first = false;
    os << "\"" << name.substr(sizeof(kPrefix) - 1) << "\":"
       << StageJson(fields);
  }
  os << "}";
  if (!total_json.empty()) os << ",\"total\":" << total_json;
  os << ",\"offsets\":" << latency::OffsetsJson();
  os << ",\"profiler\":" << profiler::StatusJson();
  // Tail plane (docs/serving.md "tail"): per-class admission ledger +
  // deadline sheds + hedge cancels, so mvtop --qos and latdoctor's
  // shed-dominance note ride the same scrape as the stage histograms.
  os << ",\"qos\":" << qos::Json();
  os << "}";
  return os.str();
}

}  // namespace

std::string PromName(const std::string& name) {
  std::string out;
  out.reserve(name.size());
  for (size_t i = 0; i < name.size(); ++i) {
    char c = name[i];
    bool ok = (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
              c == '_' || c == ':' || (c >= '0' && c <= '9' && i != 0);
    out += ok ? c : '_';
  }
  return out;
}

void SetHostMetrics(const std::string& prom_text) {
  MutexLock lk(g_mu);
  g_host_metrics = prom_text;
}

void SetHostAlerts(const std::string& alerts_json) {
  MutexLock lk(g_mu);
  g_host_alerts = alerts_json;
}

std::string LocalReport(const std::string& kind) {
  if (kind == "metrics") {
    {
      MutexLock lk(g_mu);
      if (!g_host_metrics.empty()) return g_host_metrics;
    }
    return RenderNativePrometheus();
  }
  if (kind == "health") return Zoo::Get()->OpsHealthJson();
  if (kind == "tables") return Zoo::Get()->OpsTablesJson();
  // Workload plane (docs/observability.md): per-table hot-key top-K +
  // count-min estimates, bucket-load skew, staleness, health sentinels.
  if (kind == "hotkeys") return Zoo::Get()->OpsHotKeysJson();
  // Latency-attribution plane (docs/observability.md): stage
  // histograms + clock offsets + profiler status.
  if (kind == "latency") return LatencyJson();
  // Delivery-audit plane (docs/observability.md "audit plane"):
  // acked-add ledgers, per-origin applied watermarks, dup/reorder/gap
  // anomalies, bucket checksums.  Fleet scope free via the JSON merge;
  // tools/mvaudit.py diffs acked-vs-applied across the fleet.
  if (kind == "audit") return Zoo::Get()->OpsAuditJson();
  // Replication plane (docs/replication.md): routing epoch + shard
  // map, backup identity, and the forward/ack/promotion ledger.
  // Fleet scope rides the generic JSON merge for free.
  if (kind == "replication") return Zoo::Get()->OpsReplicationJson();
  // Capacity plane (docs/observability.md "capacity plane"): proc
  // stats, arena/write-queue/registered byte gauges, per-table
  // resident bytes per bucket + the load-history ring.  Fleet scope
  // rides the generic JSON merge; tools/mvplan.py plans over it.
  if (kind == "capacity") return Zoo::Get()->OpsCapacityJson();
  // Health plane (docs/observability.md "health plane"): the native
  // stall watchdog's per-loop progress table plus the host-pushed
  // alert state (SetHostAlerts, fed by health.py each metrics flush —
  // spliced verbatim, never parsed here).  Fleet scope rides the
  // generic JSON merge; mvtop --alerts / mvdoctor render it.
  if (kind == "alerts") {
    std::string host;
    {
      MutexLock lk(g_mu);
      host = g_host_alerts;
    }
    std::ostringstream os;
    os << "{\"rank\":" << Zoo::Get()->rank()
       << ",\"watchdog\":" << watchdog::StatsJson()
       << ",\"host\":" << (host.empty() ? "null" : host) << "}";
    return os.str();
  }
  return "{\"error\":\"unknown ops kind '" + JsonEscape(kind) + "'\"}";
}

void BuildReply(const Message& query, Message* reply) {
  std::string kind = "health";
  if (!query.data.empty() && query.data[0].size() > 0)
    kind.assign(query.data[0].data(), query.data[0].size());
  std::string text = LocalReport(kind);
  reply->type = MsgType::OpsReply;
  reply->table_id = query.table_id;
  reply->msg_id = query.msg_id;
  reply->trace_id = query.trace_id;
  reply->version = query.version;  // echo the scope
  reply->data.clear();
  reply->data.emplace_back(text.data(), text.size());
}

void BuildReplicaReply(const Message& query, Message* reply) {
  reply->type = MsgType::ReplyReplica;
  reply->table_id = query.table_id;
  reply->msg_id = query.msg_id;
  reply->trace_id = query.trace_id;
  reply->data.clear();
  auto* st = Zoo::Get()->server_table(query.table_id);
  if (st) st->BuildReplica(reply);
}

// ---- flight recorder -------------------------------------------------

namespace {

// Dump rotation: beside the canonical blackbox_rank<r>.json (always the
// LATEST dump — every existing reader keeps working), each trigger also
// lands a timestamped archive blackbox_rank<r>.<ts_us>.<n>.json, and a
// small manifest lists the retained archives.  Keep-N (-blackbox_keep)
// prunes the oldest — a second trigger on the same rank no longer
// destroys the first dump's evidence.
Mutex g_rot_mu;
// mvlint: MV018-exempt(bounded at -blackbox_keep archive names —
// RotateDump prunes the oldest past the keep bound)
std::deque<std::string> g_archives GUARDED_BY(g_rot_mu);
long long g_dump_seq GUARDED_BY(g_rot_mu) = 0;

bool WriteWhole(const std::string& path, const std::string& doc) {
  std::FILE* fp = std::fopen(path.c_str(), "wb");
  if (!fp) return false;
  size_t wrote = std::fwrite(doc.data(), 1, doc.size(), fp);
  std::fclose(fp);
  return wrote == doc.size();
}

void RotateDump(const std::string& dir, const std::string& doc) {
  size_t keep = static_cast<size_t>(
      std::max<long long>(1, configure::Has("blackbox_keep")
                                 ? configure::GetInt("blackbox_keep")
                                 : 4));
  int rank = Zoo::Get()->rank();
  std::string base = "blackbox_rank" + std::to_string(rank);
  MutexLock lk(g_rot_mu);
  // ts + per-process seq: two triggers in the same microsecond (or a
  // stepped clock) still get distinct archive names.
  std::string name = base + "." + std::to_string(NowUs()) + "." +
                     std::to_string(++g_dump_seq) + ".json";
  if (!WriteWhole(dir + "/" + name, doc)) {
    Log::Error("blackbox: cannot archive %s", name.c_str());
    return;
  }
  g_archives.push_back(name);
  while (g_archives.size() > keep) {
    std::remove((dir + "/" + g_archives.front()).c_str());
    g_archives.pop_front();
  }
  std::ostringstream m;
  m << "{\"rank\":" << rank << ",\"keep\":" << keep << ",\"dumps\":[";
  for (size_t i = 0; i < g_archives.size(); ++i) {
    if (i) m << ',';
    m << "\"" << g_archives[i] << "\"";
  }
  m << "],\"total_triggers\":" << g_dump_seq << "}";
  std::string mpath = dir + "/" + base + ".manifest.json";
  std::string mtmp = mpath + ".tmp";
  if (!WriteWhole(mtmp, m.str()) ||
      std::rename(mtmp.c_str(), mpath.c_str()) != 0) {
    Log::Error("blackbox: manifest write failed for %s", mpath.c_str());
    std::remove(mtmp.c_str());
  }
}

}  // namespace

void BlackboxEvent(const std::string& kind, const std::string& detail) {
  size_t cap = static_cast<size_t>(
      std::max<long long>(16, configure::Has("blackbox_events")
                                  ? configure::GetInt("blackbox_events")
                                  : 512));
  Event ev{NowUs(), kind, detail};
  MutexLock lk(g_box_mu);
  g_events.push_back(std::move(ev));
  while (g_events.size() > cap) g_events.pop_front();
}

std::string BlackboxTrigger(const std::string& reason) {
  BlackboxEvent("trigger", reason);
  Dashboard::Record("blackbox.trigger", 0.0);
  std::string dir = configure::Has("trace_dir")
                        ? configure::GetString("trace_dir")
                        : "";
  {
    MutexLock lk(g_box_mu);
    ++g_triggers;
  }
  if (dir.empty()) return "";

  std::ostringstream os;
  os << "{\"reason\":\"" << JsonEscape(reason) << "\",";
  os << "\"rank\":" << Zoo::Get()->rank() << ",";
  os << "\"ts_us\":" << NowUs() << ",";
  os << "\"events\":[";
  {
    MutexLock lk(g_box_mu);
    bool first = true;
    for (const auto& ev : g_events) {
      if (!first) os << ',';
      first = false;
      os << "{\"ts_us\":" << ev.ts_us << ",\"kind\":\""
         << JsonEscape(ev.kind) << "\",\"detail\":\""
         << JsonEscape(ev.detail) << "\"}";
    }
  }
  os << "],\"spans\":[";
  {
    std::istringstream in(Dashboard::DumpSpans());
    std::string line;
    bool first = true;
    while (std::getline(in, line)) {
      if (line.empty()) continue;
      auto f = SplitTabs(line);
      if (f.size() < 6) continue;
      if (!first) os << ',';
      first = false;
      char hex[32];
      std::snprintf(hex, sizeof(hex), "0x%llx",
                    static_cast<unsigned long long>(std::stoll(f[1])));
      os << "{\"name\":\"" << JsonEscape(f[0]) << "\",\"trace_id\":\""
         << hex << "\",\"ts\":" << f[2] << ",\"dur\":" << f[3]
         << ",\"pid\":" << f[4] << ",\"tid\":" << f[5] << "}";
    }
  }
  os << "],\"monitors\":{";
  {
    std::istringstream in(Dashboard::Dump());
    std::string line;
    bool first = true;
    while (std::getline(in, line)) {
      if (line.empty()) continue;
      auto f = SplitTabs(line);
      if (f.size() < 3) continue;
      if (!first) os << ',';
      first = false;
      os << "\"" << JsonEscape(f[0]) << "\":{\"count\":" << f[1]
         << ",\"total_s\":" << f[2] << "}";
    }
  }
  os << "}}";

  std::string path =
      dir + "/blackbox_rank" + std::to_string(Zoo::Get()->rank()) + ".json";
  std::string tmp = path + ".tmp";
  std::FILE* fp = std::fopen(tmp.c_str(), "wb");
  if (!fp) {
    Log::Error("blackbox: cannot write %s", tmp.c_str());
    return "";
  }
  std::string doc = os.str();
  size_t wrote = std::fwrite(doc.data(), 1, doc.size(), fp);
  std::fclose(fp);
  if (wrote != doc.size() || std::rename(tmp.c_str(), path.c_str()) != 0) {
    Log::Error("blackbox: short write / rename failed for %s",
               path.c_str());
    std::remove(tmp.c_str());
    return "";
  }
  RotateDump(dir, doc);
  Log::Error("blackbox: dumped flight recorder to %s (reason: %s)",
             path.c_str(), reason.c_str());
  return path;
}

long long BlackboxTriggerCount() {
  MutexLock lk(g_box_mu);
  return g_triggers;
}

void BlackboxReset() {
  {
    MutexLock lk(g_box_mu);
    g_events.clear();
    g_triggers = 0;
  }
  {
    // Forget the rotation ledger (files on disk stay); g_dump_seq keeps
    // counting so archive names never collide across resets.
    MutexLock lk(g_rot_mu);
    g_archives.clear();
  }
  MutexLock lk(g_mu);
  g_host_metrics.clear();
  g_host_alerts.clear();
}

}  // namespace ops
}  // namespace mvtpu
