"""Host seconds of the program's problem build from the problem files
(`cli._build_problem` per star, the stack, the float64 cast), ended by a
synchronise: the CLI and problem-file layer's share of set-up."""


def read(run):
    return run.problem_build_s
