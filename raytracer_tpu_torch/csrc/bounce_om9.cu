// Kernel B's om9 builds (bounce.cuh): the om9 round key, with the ordered
// and the unordered walk, instantiated in a source of their own so that
// they compile in parallel with bounce12.cu, which launches them.
#include "bounce.cuh"

namespace rtb {

Builds builds_om9(bool ordered) {
  static const Builds on = make_builds<Key::kOm9, true>();
  static const Builds off = make_builds<Key::kOm9, false>();
  return ordered ? on : off;
}

}  // namespace rtb
