from . import main

if __name__ == "__main__":   # not triggered by a bare import
    main()
