from nmpc_nav_control_tpu_torch.qp.ipm import BoxQP, IPMSolution, solve_box_qp

__all__ = ["BoxQP", "IPMSolution", "solve_box_qp"]
