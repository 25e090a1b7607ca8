// Clang thread-safety capability annotations (no-ops elsewhere).
//
// `make analyze` builds the runtime with
//   clang++ -Wthread-safety -Werror=thread-safety
// so a Get/Add/registry path that touches a GUARDED_BY member without
// its mutex fails the BUILD — the static complement of the dynamic
// `make tsan` sweep (docs/static_analysis.md).  GCC compiles the same
// sources with every macro empty.
//
// The annotations only bite on capability-annotated mutex types;
// libstdc++'s std::mutex carries none, which is why the runtime locks
// through the annotated Mutex/MutexLock/CondVar shims in mvtpu/mutex.h
// rather than std::mutex directly.
#pragma once

#if defined(__clang__)
#define MVTPU_TSA(x) __attribute__((x))
#else
#define MVTPU_TSA(x)  // GCC/MSVC: annotations compile away
#endif

#ifndef CAPABILITY
#define CAPABILITY(x) MVTPU_TSA(capability(x))
#endif

#ifndef SCOPED_CAPABILITY
#define SCOPED_CAPABILITY MVTPU_TSA(scoped_lockable)
#endif

// Data members: which mutex must be held to touch them.
#ifndef GUARDED_BY
#define GUARDED_BY(x) MVTPU_TSA(guarded_by(x))
#endif

#ifndef PT_GUARDED_BY
#define PT_GUARDED_BY(x) MVTPU_TSA(pt_guarded_by(x))
#endif

// Functions: caller must already hold the capability (the `*Locked`
// helper convention), or acquires/releases it itself.
#ifndef REQUIRES
#define REQUIRES(...) MVTPU_TSA(requires_capability(__VA_ARGS__))
#endif

#ifndef ACQUIRE
#define ACQUIRE(...) MVTPU_TSA(acquire_capability(__VA_ARGS__))
#endif

#ifndef RELEASE
#define RELEASE(...) MVTPU_TSA(release_capability(__VA_ARGS__))
#endif

#ifndef TRY_ACQUIRE
#define TRY_ACQUIRE(...) MVTPU_TSA(try_acquire_capability(__VA_ARGS__))
#endif

#ifndef EXCLUDES
#define EXCLUDES(...) MVTPU_TSA(locks_excluded(__VA_ARGS__))
#endif

#ifndef RETURN_CAPABILITY
#define RETURN_CAPABILITY(x) MVTPU_TSA(lock_returned(x))
#endif

// Escape hatch for patterns the analysis cannot see through (e.g. the
// adopt/release dance inside CondVar, which hands a held mutex to
// std::condition_variable and takes it back).  Every use must carry a
// comment saying why the analysis is blind there.
#ifndef NO_THREAD_SAFETY_ANALYSIS
#define NO_THREAD_SAFETY_ANALYSIS MVTPU_TSA(no_thread_safety_analysis)
#endif
