import time

T_PROCESS = time.time()

if __name__ == "__main__":
    import sys

    from bench_port.run import main

    sys.exit(main(sys.argv[1:], t_process=T_PROCESS))
