from roma_torch.estimation.essential import (
    decompose_essential,
    essential_8pt,
    estimate_essential_ransac,
    estimate_pose,
)
from roma_torch.estimation.fivepoint import essential_5pt
from roma_torch.estimation.homography import estimate_homography_ransac, homography_dlt
from roma_torch.estimation.fundamental import (
    estimate_fundamental_ransac,
    estimate_pose_uncalibrated,
    fundamental_7pt,
    fundamental_8pt,
)
