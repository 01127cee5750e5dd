// A stand-in for CUDA's pipeline primitives (cp.async) on the host, beside
// cuda_runtime.h: each thread keeps its copies in commit groups and makes a
// group's copies only when __pipeline_wait_prior lets fewer groups than its
// argument stay in flight.  A kernel that read a slot before waiting for
// the copy into it would read the slot's earlier contents here, as it may
// on the card.
#pragma once
#include <cstddef>
#include <cstring>
#include <deque>
#include <vector>

struct HostCopy {
  void* dst;
  const void* src;
  size_t size;
};
inline thread_local std::vector<HostCopy> g_open_group;
inline thread_local std::deque<std::vector<HostCopy>> g_groups;

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size, size_t = 0) {
  g_open_group.push_back({dst, src, size});
}
inline void __pipeline_commit() {
  g_groups.push_back(std::move(g_open_group));
  g_open_group.clear();
}
inline void __pipeline_wait_prior(size_t prior) {
  while (g_groups.size() > prior) {
    for (const HostCopy& c : g_groups.front()) std::memcpy(c.dst, c.src, c.size);
    g_groups.pop_front();
  }
}
