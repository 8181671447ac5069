// Kernel B's pd5 builds (bounce.cuh): the pd5 round key, with the ordered
// and the unordered walk, instantiated in a source of their own so that
// they compile in parallel with bounce12.cu, which launches them.
#include "bounce.cuh"

namespace rtb {

Builds builds_pd5(bool ordered) {
  static const Builds on = make_builds<Key::kPd5, true>();
  static const Builds off = make_builds<Key::kPd5, false>();
  return ordered ? on : off;
}

}  // namespace rtb
