// The job table and lane constants that the GreedyDFS machine (dfs.cu,
// K7 and K8) and the job-table kernels (jobs.cu, K6 and K9) share, so that
// the layout is defined once.  bowtie_tpu_torch/align/dfs_device.py
// mirrors it (JOB_FIELDS, P_MAX, the modes) and _check_layout checks NJF
// against the built library.
#pragma once

// state-machine modes (dfs_device.py M_*)
constexpr int M_DONE = 0, M_JOB = 1, M_ADV = 2, M_BR = 3, M_POP = 4,
              M_REP = 5, M_RETF = 6;
constexpr int P_MAX = 32;           // partial slots a lane (-n phases 2/3)

// JOB_FIELDS order of bowtie_tpu_torch/align/dfs_device.py
enum Field {
    F_VALID, F_QLEN, F_EBWT_FW, F_FW, F_D5, F_D3, F_UNREV, F_REV1, F_REV2,
    F_REV3, F_HAM0, F_REP_EXACTS, F_REP_PARTIALS, F_HH, F_MAX_BTS,
    F_CONS_QUALS, F_QUAL_THRESH, F_RESET_RNG, F_NS_GATE, F_NS_FTAB,
    F_MAQ_ROUND, F_NPREMUT, F_PREMUT_POS0, F_PREMUT_POS1, F_PREMUT_POS2,
    F_PREMUT_REFC0, F_PREMUT_REFC1, F_PREMUT_REFC2, F_COLLECT, NJF
};
