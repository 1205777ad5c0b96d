// Warp pre-aggregation, shared by the dense-grid sum (dense_grid_sum.cu)
// and the bucketed group-by sums (bucketed_groupby_sums.cu).
//
// The lanes of a warp that hold the same slot form a group
// (__match_any_sync).  Each group sums its lanes' values by shuffles into
// its lowest lane, the leader, which alone adds the sum into the grid: one
// add per distinct slot per warp instead of one per lane, and no two
// lanes of one instruction on the same address.  The shuffle pattern
// depends only on the groups, so it is worked out once per set of rows
// (a Schedule) and replayed for every column.
//
// The reduction is the peer reduction of E. Westphal, "Voting and
// Shuffling to Optimize Atomic Operations" (NVIDIA developer blog, 2015):
// in step k every lane adds the value of its next remaining higher peer,
// and the peers whose rank has bit k set drop out, so a group of g lanes
// needs ceil(log2 g) steps, at most 5.

#pragma once

#include <cuda_runtime.h>

namespace warp_agg {

constexpr unsigned kFull = 0xffffffffu;

// Step k of `steps` is 6 bits: 0 = add nothing, else 1 + the source lane.
// `n` (the step count) is the same in every lane of the warp.
struct Schedule {
  unsigned steps;
  int n;
};

struct Group {
  Schedule s;
  bool lead;  // this lane adds its group's sum
};

// Called by all 32 lanes.  Lanes with `live` set and equal `key` (>= 0)
// form a group; every other lane stands alone and never leads.
__device__ __forceinline__ Group group_of(bool live, int key, int lane) {
  Group g{{0u, 0}, false};
  if (!__any_sync(kFull, live)) return g;
  unsigned peers = __match_any_sync(kFull, live ? key : -1);
  if (!live) peers = 1u << lane;
  g.lead = live && (__ffs(peers) - 1 == lane);
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);  // higher peers
  while (__any_sync(kFull, rest != 0u)) {
    g.s.steps |= (unsigned)__ffs(rest) << (6 * g.s.n);
    rest &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
    ++g.s.n;
  }
  return g;
}

// The sum of x over this lane's group, valid in the group's leader.
// Called by all 32 lanes with their own schedules.
__device__ __forceinline__ float group_sum(float x, Schedule s) {
  for (int k = 0; k < s.n; ++k) {
    const int src = (int)((s.steps >> (6 * k)) & 63u);
    const float t = __shfl_sync(kFull, x, (src - 1) & 31);
    if (src) x += t;
  }
  return x;
}

}  // namespace warp_agg
