#include "mvtpu/mpi_net.h"

#include <dlfcn.h>
#include <stdlib.h>

#include <chrono>
#include <climits>
#include <vector>

#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/latency.h"
#include "mvtpu/qos.h"
#include "mvtpu/log.h"

namespace mvtpu {

namespace {

// OpenMPI's public MPI_Status layout (stable across the 4.x ABI): the
// three standard fields plus two internals that only pad the struct.
struct MpiStatus {
  int source;
  int tag;
  int error;
  int cancelled_;
  size_t ucount_;
};

constexpr int kAnySource = -1;        // OpenMPI MPI_ANY_SOURCE
constexpr int kThreadMultiple = 3;    // MPI_THREAD_MULTIPLE
constexpr int kTag = 0x3777;          // all mvtpu traffic rides one tag

// Function pointers + predefined handles resolved from libmpi.  MPI_Comm
// and MPI_Datatype are opaque pointers in the OpenMPI ABI.
struct MpiApi {
  void* handle = nullptr;
  int (*init_thread)(int*, char***, int, int*) = nullptr;
  int (*initialized)(int*) = nullptr;
  int (*finalized)(int*) = nullptr;
  int (*finalize)() = nullptr;
  int (*comm_rank)(void*, int*) = nullptr;
  int (*comm_size)(void*, int*) = nullptr;
  int (*isend)(const void*, int, void*, int, int, void*, void**) = nullptr;
  int (*test)(void**, int*, MpiStatus*) = nullptr;
  int (*recv)(void*, int, void*, int, int, void*, MpiStatus*) = nullptr;
  int (*iprobe)(int, int, void*, int*, MpiStatus*) = nullptr;
  int (*get_count)(const MpiStatus*, void*, int*) = nullptr;
  int (*cancel)(void**) = nullptr;
  int (*request_free)(void**) = nullptr;
  void* comm_world = nullptr;
  void* byte = nullptr;
  bool ok = false;
};

MpiApi LoadMpi() {
  MpiApi api;
  // RTLD_GLOBAL: OpenMPI dlopens its MCA plugins, which resolve symbols
  // against the already-loaded libmpi.
  for (const char* name : {"libmpi.so.40", "libmpi.so", "libmpi.so.80",
                           "libmpi.so.12"}) {
    api.handle = dlopen(name, RTLD_NOW | RTLD_GLOBAL);
    if (api.handle) break;
  }
  if (!api.handle) return api;
  auto sym = [&](const char* n) { return dlsym(api.handle, n); };
  api.init_thread = reinterpret_cast<int (*)(int*, char***, int, int*)>(
      sym("MPI_Init_thread"));
  api.initialized = reinterpret_cast<int (*)(int*)>(sym("MPI_Initialized"));
  api.finalized = reinterpret_cast<int (*)(int*)>(sym("MPI_Finalized"));
  api.finalize = reinterpret_cast<int (*)()>(sym("MPI_Finalize"));
  api.comm_rank =
      reinterpret_cast<int (*)(void*, int*)>(sym("MPI_Comm_rank"));
  api.comm_size =
      reinterpret_cast<int (*)(void*, int*)>(sym("MPI_Comm_size"));
  api.isend = reinterpret_cast<int (*)(const void*, int, void*, int, int,
                                       void*, void**)>(sym("MPI_Isend"));
  api.test =
      reinterpret_cast<int (*)(void**, int*, MpiStatus*)>(sym("MPI_Test"));
  api.recv = reinterpret_cast<int (*)(void*, int, void*, int, int, void*,
                                      MpiStatus*)>(sym("MPI_Recv"));
  api.iprobe = reinterpret_cast<int (*)(int, int, void*, int*, MpiStatus*)>(
      sym("MPI_Iprobe"));
  api.get_count = reinterpret_cast<int (*)(const MpiStatus*, void*, int*)>(
      sym("MPI_Get_count"));
  api.cancel = reinterpret_cast<int (*)(void**)>(sym("MPI_Cancel"));
  api.request_free =
      reinterpret_cast<int (*)(void**)>(sym("MPI_Request_free"));
  // Predefined handles are data symbols in the OpenMPI ABI; their
  // absence means some other MPI (e.g. MPICH's integer handles), whose
  // ABI these declarations would corrupt — treat as unavailable.
  api.comm_world = sym("ompi_mpi_comm_world");
  api.byte = sym("ompi_mpi_byte");
  api.ok = api.init_thread && api.initialized && api.finalized &&
           api.finalize && api.comm_rank && api.comm_size && api.isend &&
           api.test && api.recv && api.iprobe && api.get_count &&
           api.cancel && api.request_free && api.comm_world && api.byte;
  return api;
}

MpiApi& Api() {
  static MpiApi api = LoadMpi();
  return api;
}

// Serial-mode lock: MPI state is process-wide, so the lock is too.
// A namespace-scope Mutex (constant-initialized: std::mutex's ctor is
// constexpr) rather than a function-local static, so GUARDED_BY /
// REQUIRES below have a name to bind to.
Mutex g_mpi_mu;

// Payloads of timed-out/failed sends.  MPI_Request_free drops our
// handle but the library may still read the user buffer until the
// (cancelled or completed) send drains, so the blob is parked for the
// life of the process — bounded by the number of failures, each of
// which already logged an error.
std::vector<Blob>& OrphanedSendBufs() REQUIRES(g_mpi_mu) {
  static auto* v = new std::vector<Blob>();
  return *v;
}

// MPI_Finalize is terminal for the process; latch it so a second
// Init fails cleanly instead of aborting inside libmpi.
std::atomic<bool> g_finalized{false};
// Whether MpiNet::Init performed the MPI_Init — an embedding app that
// initialized MPI itself keeps ownership, and Stop() must not finalize
// the host program's MPI out from under it.
std::atomic<bool> g_we_initialized{false};

}  // namespace

bool MpiNet::Available() { return Api().ok; }

bool MpiNet::Init(InboundFn fn) {
  MpiApi& api = Api();
  if (!api.ok) {
    Log::Error("-net_type=mpi: no usable libmpi (dlopen failed or the "
               "ABI is not OpenMPI's)");
    return false;
  }
  if (g_finalized.load()) {
    Log::Error("-net_type=mpi: MPI was already finalized in this process "
               "(MPI allows one init/finalize cycle; use -net_type=tcp "
               "for restartable runs)");
    return false;
  }
  {
    MutexLock lk(g_mpi_mu);
    int inited = 0;
    api.initialized(&inited);
    if (!inited) {
      // No launcher environment (mpirun/PMIx exports these) → isolated
      // singleton mode, which needs no orted helper binary.
      if (!getenv("OMPI_COMM_WORLD_SIZE") && !getenv("PMIX_RANK") &&
          !getenv("PMI_RANK"))
        setenv("OMPI_MCA_ess_singleton_isolated", "1", 0);
      int provided = 0;
      if (api.init_thread(nullptr, nullptr, kThreadMultiple, &provided) !=
          0) {
        Log::Error("MPI_Init_thread failed");
        return false;
      }
      g_we_initialized.store(true);
      // Serial-mode locking means any `provided` level works; still log
      // a surprising one.
      if (provided < kThreadMultiple)
        Log::Info("MPI provided thread level %d (< MULTIPLE); serial-mode "
                  "locking covers it", provided);
    }
    api.comm_rank(api.comm_world, &rank_);
    api.comm_size(api.comm_world, &size_);
  }
  inbound_ = std::move(fn);
  running_.store(true);
  probe_thread_ = std::thread(&MpiNet::ProbeLoop, this);
  Log::Info("MpiNet up: rank %d/%d (tag %#x)", rank_, size_, kTag);
  return true;
}

size_t MpiNet::OrphanedSendBufCount() {
  MutexLock lk(g_mpi_mu);
  return OrphanedSendBufs().size();
}

bool MpiNet::Send(int dst_rank, const Message& msg) {
  MpiApi& api = Api();
  if (!running_.load() || dst_rank < 0 || dst_rank >= size_) return false;
  // Wire-send latency + trace span (same contract as TcpNet::Send).
  Monitor mon("Net::Send", msg.trace_id);
  // Serialize OUTSIDE the MPI lock (full-payload copy).
  Blob wire = msg.Serialize();
  if (wire.size() > static_cast<size_t>(INT_MAX)) {
    Log::Error("MpiNet: %zu-byte message exceeds MPI's int count",
               wire.size());
    return false;
  }
  // Isend + Test poll, RELEASING the lock between polls: a blocking
  // MPI_Send under g_mpi_mu would starve this rank's own ProbeLoop of
  // the lock, and two ranks exchanging rendezvous-size messages would
  // deadlock (neither probe thread could post the matching Recv).
  void* req = nullptr;
  {
    MutexLock lk(g_mpi_mu);
    if (api.isend(wire.data(), static_cast<int>(wire.size()), api.byte,
                  dst_rank, kTag, api.comm_world, &req) != 0)
      return false;
  }
  // The poll is bounded by -rpc_timeout_ms: a dead or wedged peer that
  // never posts the matching Recv must not wedge this rank forever —
  // the same fail-fast contract TcpNet implements.  On expiry the
  // request is cancelled best-effort (MPI may ignore cancel on sends)
  // and freed; the payload blob is parked in OrphanedSendBufs() because
  // the library can keep reading it until the send actually drains.
  // Has() guard: MpiNet can be driven standalone (tests, embedders)
  // before Zoo registered the flag defaults.  <=0 keeps the flag's
  // documented wait-forever contract (configure.cc).
  const int64_t timeout_ms = configure::Has("rpc_timeout_ms")
                                 ? configure::GetInt("rpc_timeout_ms")
                                 : 30000;
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(timeout_ms);
  while (true) {
    {
      MutexLock lk(g_mpi_mu);
      int done = 0;
      MpiStatus st{};
      if (api.test(&req, &done, &st) != 0) {
        // Error path mirrors the timeout branch below: MPI_Test failing
        // does NOT mean the send drained — the library may still read
        // the user buffer, so free our handle and park the payload
        // instead of letting `wire` die on return.
        api.cancel(&req);
        api.request_free(&req);
        OrphanedSendBufs().push_back(std::move(wire));
        Log::Error("MpiNet::Send to rank %d: MPI_Test failed; request "
                   "freed, payload parked", dst_rank);
        return false;
      }
      if (done) {
        // Same wire-byte ledger as TcpNet (count = msgs, total = bytes).
        Dashboard::Record("net.bytes.sent",
                          static_cast<double>(wire.size()));
        return true;
      }
      if (timeout_ms > 0 && std::chrono::steady_clock::now() >= deadline) {
        api.cancel(&req);
        api.request_free(&req);
        OrphanedSendBufs().push_back(std::move(wire));
        Log::Error("MpiNet::Send to rank %d timed out after %lld ms "
                   "(peer dead or never posted the matching Recv)",
                   dst_rank, static_cast<long long>(timeout_ms));
        return false;
      }
    }
    std::this_thread::sleep_for(std::chrono::microseconds(50));
  }
}

void MpiNet::ProbeLoop() {
  MpiApi& api = Api();
  while (running_.load()) {
    Blob buf;
    bool got = false;
    {
      MutexLock lk(g_mpi_mu);
      int flag = 0;
      MpiStatus st{};
      if (api.iprobe(kAnySource, kTag, api.comm_world, &flag, &st) != 0)
        break;
      if (flag) {
        int n = 0;
        api.get_count(&st, api.byte, &n);
        buf = Blob(static_cast<size_t>(n));
        MpiStatus recv_st{};
        // Probe + matched Recv under one lock hold: no other thread
        // receives, so the probed message cannot be stolen.
        if (api.recv(buf.data(), n, api.byte, st.source, kTag,
                     api.comm_world, &recv_st) == 0)
          got = true;
      }
    }
    if (got) {
      Dashboard::Record("net.bytes.recv", static_cast<double>(buf.size()));
      Message m = Message::Deserialize(buf);
      latency::StampRecv(&m);  // frame-complete on the MPI wire
      qos::AdoptDeadline(&m);  // tail plane: deadline adopted at recv
      inbound_(std::move(m));  // outside the MPI lock
    } else
      std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
}

void MpiNet::Stop() {
  if (!running_.exchange(false)) return;
  if (probe_thread_.joinable()) probe_thread_.join();
  MpiApi& api = Api();
  MutexLock lk(g_mpi_mu);
  int inited = 0, fin = 0;
  api.initialized(&inited);
  api.finalized(&fin);
  // Finalize only the MPI we started: an embedding app that called
  // MPI_Init itself keeps ownership of its MPI lifetime.
  if (inited && !fin && g_we_initialized.load()) {
    g_finalized.store(true);
    api.finalize();
  }
}

}  // namespace mvtpu
