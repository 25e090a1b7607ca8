// MpiNet — the literal MPI wire transport (reference
// include/multiverso/net/mpi_net.h, SURVEY.md §2.17), selected with
// `-net_type=mpi`.
//
// No mpi.h ships in this image, so libmpi is dlopen'd at runtime and
// the (OpenMPI) ABI is declared locally: predefined handles like
// MPI_COMM_WORLD are exported data symbols (`ompi_mpi_comm_world`), and
// MPI_Status has the stable public layout.  `Available()` reports
// whether a usable libmpi resolved — callers (and tests) gate on it.
//
// Rank/size come from MPI itself, not a machine file: under `mpirun -n
// N` the whole job shows up; under a plain process launch OpenMPI's
// isolated singleton mode (set automatically when no PMIx launcher
// environment is present) gives rank 0 / size 1.
//
// Thread model: serial mode — every MPI call runs under one
// process-wide mutex (the reference's MPINetWrapper serialized the
// same way), with an Iprobe poll loop instead of a blocking Probe so
// Stop() cannot hang on a transport with no inbound traffic.
//
// Lifecycle restriction (MPI's, not ours): MPI_Finalize is terminal —
// one Init/Stop cycle per process; a second Init after Stop fails with
// a clear error instead of aborting inside libmpi.
#pragma once

#include <atomic>
#include <thread>

#include "mvtpu/net.h"

namespace mvtpu {

class MpiNet : public Net {
 public:
  using InboundFn = Net::InboundFn;

  ~MpiNet() override { Stop(); }

  // True when a dlopen-able libmpi with the expected ABI is present.
  static bool Available();

  // Number of send payloads parked for the life of the process after a
  // timed-out or failed send (MPI may keep reading a buffer whose
  // request we freed).  Diagnostic/test hook: healthy runs stay at 0;
  // every increment already logged an error.
  static size_t OrphanedSendBufCount();

  // Initialize MPI (MPI_THREAD_MULTIPLE requested; serial-mode locking
  // regardless), read rank/size, start the inbound probe thread.
  bool Init(InboundFn fn);

  bool Send(int dst_rank, const Message& msg) override;
  void Stop() override;

  int rank() const override { return rank_; }
  int size() const override { return size_; }
  const char* engine() const override { return "mpi"; }

 private:
  void ProbeLoop();

  InboundFn inbound_;
  int rank_ = 0;
  int size_ = 1;
  std::thread probe_thread_;
  std::atomic<bool> running_{false};
};

}  // namespace mvtpu
