"""The benchmark's frozen arithmetic: the card's peaks, the work a kernel's
inputs need, and the reduction of a profiler trace to busy time and gaps.
Later changes to the program do not move it."""
